"""Public-names guard: the port covers every module and top-level public
name of ssak_tpu.

Both packages are walked by AST; ssak_tpu's sources are read as text and
nothing of it is imported. A module's public names are its functions,
classes and assigned names that do not start with an underscore, and in a
package's __init__.py also the names it imports (its exports). The test
fails on any module or name of ssak_tpu that the port lacks under the same
path, unless COUNTERPARTS names what takes its place and why; that table is
the one in ROADMAP.md §3. Each counterpart must exist in the port, and an
entry whose name the port has since gained under ssak_tpu's own name must
leave the table. The scripts of the top-level tools/ and demo/ are outside
the walk."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (ssak_tpu module, name or None for the whole module) -> (counterparts in the port as "module:name", why)
COUNTERPARTS = {
    ("audio/__init__.py", "resample_jax"): (["audio/__init__.py:resample_torch"],
                                            "the resampler on a tensor's device is PyTorch's, not JAX's"),
    ("audio/resample.py", "resample_jax"): (["audio/resample.py:resample_torch"],
                                            "the resampler on a tensor's device is PyTorch's, not JAX's"),
    ("audio/native/__init__.py", "get_native_lib"): (
        ["audio/native/__init__.py:library"],
        "one library per C++ source, built by g++ at first use; a failed build raises instead of returning None"),
    ("audio/native/build.py", None): (["ops/_build.py:host_library"],
                                      "every host C++ source builds through one g++ helper, keyed on its hash"),
    ("decode/native/__init__.py", None): (["decode/native_lm.py:NativeNgramLM"],
                                          "the scorer's loader lives in decode/native_lm beside its C++ source"),
    ("decode/native/build.py", None): (["ops/_build.py:host_library"],
                                       "every host C++ source builds through one g++ helper, keyed on its hash"),
    ("ops/ctc_pallas.py", None): (["ops/ctc_fused.py:ctc_loss_fast"],
                                  "K1's Pallas kernel is the CUDA kernel csrc/ctc_fused.cu behind ops/ctc_fused"),
    ("models/layers.py", "flash_self_attention"): (
        ["ops/flash_attention.py:flash_self_attention"],
        "L1 is the port's CUDA kernel (csrc/flash_attention.cu); its wrapper lives in ops/flash_attention"),
    ("models/whisper.py", "stack_decoder_blocks"): (
        [], "a lax.scan layout of the decoder's blocks; the port runs its blocks as a list and has no counterpart"),
    ("utils/flops.py", "tpu_peak_flops"): (
        ["utils/flops.py:peak_flops"],
        "the card's dense bf16 peak, read from its name; None (and a warning) for a card outside its table"),
    ("parallel/mesh.py", "initialize_multihost"): (
        ["parallel/mesh.py:init_distributed"],
        "hosts join through torchrun's environment (or explicit arguments) into torch.distributed process groups"),
}
for _name in ("apply_platform_env", "force_cpu", "default_device", "platform", "is_tpu", "num_devices"):
    COUNTERPARTS[("utils/env.py", _name)] = (
        ["utils/env.py:resolve_device"],
        "JAX's platform switches and device queries become one rule: cuda unless the caller asks for the CPU")


def _public_names(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    init = os.path.basename(path) == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(e.id for t in node.targets for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _walk(package):
    root = os.path.join(REPO, package)
    mods = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                mods[os.path.relpath(path, root).replace(os.sep, "/")] = _public_names(path)
    return mods


def test_port_covers_every_module_and_public_name():
    ref, port = _walk("ssak_tpu"), _walk("ssak_tpu_torch")
    assert len(ref) > 80 and len(port) > 100
    missing = []
    for mod, names in sorted(ref.items()):
        if mod not in port:
            if (mod, None) not in COUNTERPARTS:
                missing.append(mod)
            continue
        missing += [f"{mod}:{n}" for n in sorted(names - port[mod]) if (mod, n) not in COUNTERPARTS
                    and (mod, None) not in COUNTERPARTS]
    assert not missing, f"ssak_tpu modules or names the port lacks, with no counterpart in COUNTERPARTS: {missing}"


def test_counterparts_are_current_and_exist():
    ref, port = _walk("ssak_tpu"), _walk("ssak_tpu_torch")
    for (mod, name), (targets, why) in COUNTERPARTS.items():
        assert why and mod in ref, (mod, name)
        if name is None:
            assert mod not in port, f"{mod} is in the port now: take it out of COUNTERPARTS"
        else:
            assert name in ref[mod], (mod, name)
            assert name not in port.get(mod, set()), f"{mod}:{name} is in the port now: take it out of COUNTERPARTS"
        for target in targets:
            tmod, tname = target.split(":")
            assert tmod in port and tname in port[tmod], f"counterpart {target} of {mod}:{name} is not in the port"


def test_package_exports_match():
    """Every name a package's __init__ of ssak_tpu exports (or its
    counterpart) resolves in the port's package when it is imported."""
    import importlib

    ref, port = _walk("ssak_tpu"), _walk("ssak_tpu_torch")
    inits = sorted(m for m in ref if m.endswith("__init__.py") and m in port and ref[m])
    assert len(inits) >= 15
    for mod in inits:
        pkg = importlib.import_module("ssak_tpu_torch" + ("." + mod[: -len("/__init__.py")].replace("/", ".")
                                                          if mod != "__init__.py" else ""))
        for name in ref[mod]:
            swap = COUNTERPARTS.get((mod, name))
            want = swap[0][0].split(":")[1] if swap else name
            assert hasattr(pkg, want), (mod, want)
