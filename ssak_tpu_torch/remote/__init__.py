from ssak_tpu_torch.remote.client import build_transcription_config, remote_streaming, remote_transcribe

__all__ = ["remote_transcribe", "remote_streaming", "build_transcription_config"]
