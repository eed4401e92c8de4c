"""Small host-side helpers (counterpart of ssak_tpu.utils.misc:
`get_cache_dir`, `hashmd5`, `walk_files`, `save_source_dir`,
`run_command`)."""

import hashlib
import json
import os
import shutil
import subprocess


def get_cache_dir(name: str = "ssak_tpu_torch") -> str:
    """Return (and create) the port's per-user cache directory:
    $SSAK_TPU_TORCH_CACHE, else $XDG_CACHE_HOME/<name>, else
    $HOME/.cache/<name>, else /tmp/<name>-cache. Apart from ssak_tpu's
    (which reads $SSAK_TPU_CACHE and defaults to the name ssak_tpu), so the
    two packages never share a cache file."""
    root = os.environ.get("SSAK_TPU_TORCH_CACHE")
    if not root:
        xdg = os.environ.get("XDG_CACHE_HOME")
        home = os.environ.get("HOME")
        if xdg:
            root = os.path.join(xdg, name)
        elif home and os.access(home, os.W_OK):
            root = os.path.join(home, ".cache", name)
        else:
            root = os.path.join("/tmp", f"{name}-cache")
    os.makedirs(root, exist_ok=True)
    return root


def hashmd5(obj) -> str:
    """Deterministic md5 of a JSON-able (or repr-able) object, hashed over a
    canonical JSON encoding so it is stable across Python versions."""
    try:
        payload = json.dumps(obj, sort_keys=True, default=repr)
    except TypeError:
        payload = repr(obj)
    return hashlib.md5(payload.encode("utf-8")).hexdigest()


def walk_files(root: str, ignore_extensions=None, verbose: bool = False):
    """Yield all file paths under root (sorted, deterministic order)."""
    ignore_extensions = tuple(ignore_extensions or ())
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if ignore_extensions and fn.endswith(ignore_extensions):
                continue
            yield os.path.join(dirpath, fn)


def save_source_dir(dest_dir: str) -> str:
    """Snapshot the ssak_tpu_torch source tree into a run directory for provenance."""
    import ssak_tpu_torch

    src = os.path.dirname(os.path.abspath(ssak_tpu_torch.__file__))
    dest = os.path.join(dest_dir, "src", "ssak_tpu_torch")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(src, dest, ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o"))
    return dest


def run_command(cmd, check: bool = True, capture: bool = True) -> str:
    """Run a command (a string through the shell, a list without it) and
    return its stdout; raises CalledProcessError on failure when `check`."""
    result = subprocess.run(
        cmd,
        shell=isinstance(cmd, str),
        check=check,
        stdout=subprocess.PIPE if capture else None,
        stderr=subprocess.PIPE if capture else None,
    )
    return result.stdout.decode("utf-8", errors="replace") if capture else ""
