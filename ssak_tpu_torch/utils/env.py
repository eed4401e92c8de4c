"""Device resolution for the port's entry points.

Counterpart of ssak_tpu.utils.env (platform helpers). The rule: run on
`cuda` unless the caller asks for the CPU. With no GPU and no such request
the entry point raises — it never drops to the CPU on its own.
"""


def resolve_device(device=None):
    """None -> cuda; "cpu"/"cuda"/"cuda:N"/torch.device accepted. Raises
    RuntimeError when a CUDA device is asked for (or defaulted to) and
    none is available."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
