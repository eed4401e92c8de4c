from ssak_tpu_torch.audio.io import load_audio, save_audio

__all__ = ["load_audio", "save_audio"]
