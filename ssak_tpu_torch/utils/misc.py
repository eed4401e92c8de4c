"""Small host-side helpers (counterpart of ssak_tpu.utils.misc: `hashmd5`,
`save_source_dir`)."""

import hashlib
import json
import os
import shutil


def hashmd5(obj) -> str:
    """Deterministic md5 of a JSON-able (or repr-able) object, hashed over a
    canonical JSON encoding so it is stable across Python versions."""
    try:
        payload = json.dumps(obj, sort_keys=True, default=repr)
    except TypeError:
        payload = repr(obj)
    return hashlib.md5(payload.encode("utf-8")).hexdigest()


def save_source_dir(dest_dir: str) -> str:
    """Snapshot the ssak_tpu_torch source tree into a run directory for provenance."""
    import ssak_tpu_torch

    src = os.path.dirname(os.path.abspath(ssak_tpu_torch.__file__))
    dest = os.path.join(dest_dir, "src", "ssak_tpu_torch")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(src, dest, ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o"))
    return dest
