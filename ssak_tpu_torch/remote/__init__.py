from ssak_tpu_torch.remote.client import remote_streaming

__all__ = ["remote_streaming"]
