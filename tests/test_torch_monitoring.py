"""The port's monitoring, utils exports, run_command and quantized-tree
helpers against ssak_tpu's on the CPU.

Exact, as the same Python code: the tic / toc timers (their returns, totals
and printed lines under one fake clock), utils/__init__'s exports,
run_command's output and failures, is_quantized_kernel, and
dequantize_params, bit for bit on ssak_tpu-layout trees and on the port's
quantized modules (int8 and int4: the integer values times their f32
scales, rounded once, in both). device_memory_stats on the CPU gives the
three keys at 0 (without a card, no device means the card, and raises:
tests/test_torch_guards.py). profile_trace writes a Chrome-trace JSON that
holds an annotated region."""

import io
import json
import os
import subprocess

import numpy as np
import pytest
import torch

import jax

import ssak_tpu.utils as JU
import ssak_tpu.utils.misc as JMISC
import ssak_tpu.utils.monitoring as JMON
import ssak_tpu_torch.utils as TU
import ssak_tpu_torch.utils.misc as TMISC
import ssak_tpu_torch.utils.monitoring as TMON
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu_torch.models import layers as L
from ssak_tpu_torch.models import quant as TQ
from ssak_tpu_torch.models.convert import wav2vec2_from_tree, wav2vec2_to_tree


class _Clock:
    """A fake `time` module whose perf_counter steps through fixed values."""

    def __init__(self, values):
        self.values = list(values)

    def perf_counter(self):
        return self.values.pop(0)


# one value a tic, two a toc (its clock and the default it builds for an unknown name)
CLOCK = [1.0, 1.25, 1.5, 2.0, 5.5, 6.0, 6.125, 6.5, 10.0, 10.5, 11.0]


def _timer_run(mon, monkeypatch):
    monkeypatch.setattr(mon, "time", _Clock(CLOCK))
    mon.reset_timers()
    out = io.StringIO()
    got = [mon.tic("a"), mon.toc("a", stream=out), mon.tic("b"), mon.toc("b", stream=out, log_total=True),
           mon.tic("a"), mon.toc("a", stream=out, log_total=True), mon.toc("never", stream=out),
           mon.toc_total("a"), mon.toc_total("b"), mon.toc_total("never"), mon.toc_total("unknown")]
    mon.reset_timers()
    return got, out.getvalue(), mon.toc_total("a")


def test_timers_match_jax(monkeypatch):
    got = _timer_run(TMON, monkeypatch)
    want = _timer_run(JMON, monkeypatch)
    assert got == want
    assert got[0][7] == 0.25 + 0.375 and got[0][6] == -0.5 and got[2] == 0.0


def test_utils_exports_match_jax():
    assert TU.__all__ == JU.__all__
    for name in TU.__all__:
        assert callable(getattr(TU, name)) or name == "logger"
    assert TU.tic is TMON.tic and TU.device_memory_stats is TMON.device_memory_stats


@pytest.mark.parametrize("cmd", ["echo one two; echo three", ["printf", "%s|", "a b", "c"], "printf 'é\\xff'"],
                         ids=["shell", "argv", "undecodable"])
def test_run_command_matches_jax(cmd):
    assert TMISC.run_command(cmd) == JMISC.run_command(cmd)
    assert TMISC.run_command(cmd, capture=False) == JMISC.run_command(cmd, capture=False) == ""


def test_run_command_failure_matches_jax():
    for mod in (TMISC, JMISC):
        with pytest.raises(subprocess.CalledProcessError):
            mod.run_command("exit 3")
    assert TMISC.run_command("echo x; exit 3", check=False) == JMISC.run_command("echo x; exit 3", check=False) == "x\n"


def test_device_memory_stats_on_the_cpu():
    assert TMON.device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    assert TMON.device_memory_stats(torch.device("cpu")) == TMON.device_memory_stats("cpu")


def test_profile_trace_writes_chrome_json_with_the_region(tmp_path):
    x = torch.randn(64, 64)
    with TMON.profile_trace(str(tmp_path / "trace"), create_perfetto_link=True) as tr:
        with TMON.annotate("host_modules.test_region"):
            (x @ x).sum()
    assert tr.path and os.path.dirname(tr.path) == str(tmp_path / "trace")
    with open(tr.path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert "host_modules.test_region" in names
    assert any(n and "mm" in n for n in names)


def _jax_tree():
    cfg = JW.make_config("tiny_test", hidden_size=64, intermediate_size=128, vocab_size=64)
    return jax.tree_util.tree_map(np.asarray, JW.init_params(jax.random.PRNGKey(3), cfg))


def test_is_quantized_kernel_matches_jax():
    q8 = JQ.quantize_kernel(np.ones((64, 64), np.float32), bits=8)
    q4 = JQ.quantize_kernel(np.ones((64, 64), np.float32), bits=4)
    for leaf in (q8, q4, {"kernel": np.ones(3)}, np.ones(3), {"scale": np.ones(1)}, None):
        assert TQ.is_quantized_kernel(leaf) == JQ.is_quantized_kernel(leaf)
    lin = L.Linear(torch.ones(64, 64))
    assert TQ.is_quantized_kernel(L.QuantLinear(*TQ.quantize_kernel(lin.weight.t(), 8))) and not TQ.is_quantized_kernel(lin)


def _assert_trees_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_params_on_jax_trees_matches_jax(bits):
    """An ssak_tpu-layout tree quantized by ssak_tpu: both packages give the
    same dense f32 arrays, bit for bit, and the same tree around them
    (lists and tuples kept)."""
    qtree = JQ.quantize_params(_jax_tree(), bits=bits)
    qtree["extra"] = (qtree["lm_head"], [np.arange(3)])
    want = JQ.dequantize_params(qtree)
    got = TQ.dequantize_params(qtree)
    _assert_trees_equal(got, want)
    assert not any(JQ.is_quantized_kernel(v) for v in jax.tree_util.tree_leaves(
        got, is_leaf=JQ.is_quantized_kernel) if isinstance(v, dict))


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_params_on_port_modules_matches_jax(bits):
    """The port's module quantized in place by its quantize_params: the
    dequantized copy's tree equals ssak_tpu's dequantized tree bit for bit;
    the quantized module is left as it was (its layers still quantized)."""
    tree = _jax_tree()
    module = TQ.quantize_params(wav2vec2_from_tree(tree), bits=bits)
    n_quant = sum(isinstance(m, L.QuantLinear) for m in module.modules())
    dense = TQ.dequantize_params(module)
    assert n_quant >= 4 and sum(isinstance(m, L.QuantLinear) for m in module.modules()) == n_quant
    assert not any(isinstance(m, L.QuantLinear) for m in dense.modules())
    _assert_trees_equal(wav2vec2_to_tree(dense), JQ.dequantize_params(JQ.quantize_params(tree, bits=bits)))
