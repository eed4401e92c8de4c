"""The port's accurate and long-form Whisper paths against ssak_tpu on the
CPU: beam search, sampling, best-of, the timestamp rules, the window decode
with padded prompts, the fallback and seek loops (driven by the same
scripted decoders), and the real long-form and accurate paths on seeded
audio. Decoding runs the tiny_test model in f32 with the same weights in
both packages (ssak_tpu's seeded tree, converted), so tokens, segments and
texts agree exactly at T = 0; scores agree to f32 sum order (1e-4 of
their size), or to 2e-3 with int8 K/V caches, where both packages quantize
q and the probabilities and a sum-order difference can move a value by one
int8 step. At T > 0 the two packages draw from different generators, so
the tests hold the distribution of the port's sampler, not its tokens."""

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssak_tpu.infer.whisper_infer as JWI
import ssak_tpu_torch.infer.whisper_infer as WI
from ssak_tpu.infer.general import LoadedModel as JLoadedModel, ModelType as JModelType
from ssak_tpu.models import quant as JQ
from ssak_tpu.models import whisper as JW
from ssak_tpu_torch.infer.general import from_tree
from ssak_tpu_torch.models import whisper as W
from ssak_tpu_torch.models.convert import whisper_from_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small ops. With several test workers on one
    host, torch's intra-op thread pool oversubscribes the cores and its
    threads spin at every op; one thread keeps the file's time what it is
    alone. Restored afterwards for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(W.WhisperConfig)}
    return W.WhisperConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


@pytest.fixture(scope="module")
def tiny():
    """(JAX f32 tiny_test config, numpy tree, mel batch (3, 80, 200))."""
    cfg = JW.make_config("tiny_test", dtype="float32")
    params = jax.tree_util.tree_map(np.array, JW.init_params(jax.random.PRNGKey(0), cfg))
    mel = (np.random.RandomState(1).randn(3, cfg.n_mels, 200) * 0.3).astype(np.float32)
    return cfg, params, mel


def _both(tiny, kv_int8):
    cfg, params, mel = tiny
    cfg = dataclasses.replace(cfg, kv_int8=kv_int8)
    return cfg, jax.tree_util.tree_map(jnp.asarray, params), _port_cfg(cfg), whisper_from_tree(params)


def _close(got, ref, kv_int8):
    ref = np.asarray(ref, np.float32)
    rel = 2e-3 if kv_int8 else 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


KV = pytest.mark.parametrize("kv_int8", [False, True], ids=["float_kv", "int8_kv"])


# --- the decode family --------------------------------------------------------


@KV
def test_beam_decode_matches_jax(tiny, kv_int8):
    cfg, jp, tcfg, tm = _both(tiny, kv_int8)
    mel = tiny[2]
    prompt = [cfg.sot, cfg.no_timestamps]
    rt, rl, rs = JW.beam_decode(jp, jnp.asarray(mel), cfg, prompt, beam_size=5, max_tokens=10)
    gt, gl, gs = W.beam_decode(tm, torch.from_numpy(mel), tcfg, prompt, beam_size=5, max_tokens=10)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    _close(gs, rs, kv_int8)
    # beam 1 is greedy, in both packages
    b1 = W.beam_decode(tm, torch.from_numpy(mel), tcfg, prompt, beam_size=1, max_tokens=10)[0]
    assert torch.equal(b1, W.greedy_decode(tm, torch.from_numpy(mel), tcfg, prompt, max_tokens=10)[0])


def test_beam_decode_length_penalty_matches_jax(tiny):
    cfg, jp, tcfg, tm = _both(tiny, False)
    mel = tiny[2][:2]
    prompt = [cfg.sot, cfg.no_timestamps]
    rt, rl, rs = JW.beam_decode(jp, jnp.asarray(mel), cfg, prompt, beam_size=3, max_tokens=8, length_penalty=1.0)
    gt, gl, gs = W.beam_decode(tm, torch.from_numpy(mel), tcfg, prompt, beam_size=3, max_tokens=8, length_penalty=1.0)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    _close(gs, rs, False)


@KV
def test_sample_decode_t0_matches_jax(tiny, kv_int8):
    """T = 0 is argmax in both packages (best_of is ignored there)."""
    cfg, jp, tcfg, tm = _both(tiny, kv_int8)
    mel = tiny[2]
    prompt = [cfg.sot, cfg.no_timestamps]
    rt, rl, rs = JW.sample_decode(jp, jnp.asarray(mel), cfg, prompt, jax.random.PRNGKey(0), temperature=0.0,
                                  max_tokens=9, best_of=5)
    gt, gl, gs = W.sample_decode(tm, torch.from_numpy(mel), tcfg, prompt, 0, temperature=0.0, max_tokens=9, best_of=5)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    _close(gs, rs, kv_int8)


def test_sample_decode_t_positive_is_seeded(tiny):
    """At T > 0: the same seed gives the same draws, best_of keeps shapes,
    and sum_logprob is the log probability of what was drawn (<= 0)."""
    _cfg, _jp, tcfg, tm = _both(tiny, False)
    mel = torch.from_numpy(tiny[2])
    prompt = [tcfg.sot, tcfg.no_timestamps]
    a = W.sample_decode(tm, mel, tcfg, prompt, 3, temperature=0.8, max_tokens=6, best_of=4)
    b = W.sample_decode(tm, mel, tcfg, prompt, 3, temperature=0.8, max_tokens=6, best_of=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tuple(a[0].shape) == (3, 6) and tuple(a[1].shape) == tuple(a[2].shape) == (3,)
    assert bool((a[2] <= 0).all())


def _window_prompts(cfg, P, plens, seed):
    rng = np.random.RandomState(seed)
    buf = np.full((len(plens), P), cfg.eot, np.int32)
    for b, n in enumerate(plens):
        ids = ([cfg.sot_prev] + list(rng.randint(6, cfg.timestamp_begin + 20, n - 2)) if n > 1 else []) + [cfg.sot]
        buf[b, P - len(ids):] = ids
    return buf, np.asarray(plens, np.int32)


@KV
@pytest.mark.parametrize("with_ts", [True, False], ids=["timestamps", "no_timestamps"])
def test_decode_window_matches_jax(tiny, kv_int8, with_ts):
    """Prompts of three lengths in one batch (pad_len 16, 13, 8 of P = 17):
    the same tokens, sum_logprob and no_speech_prob. The port starts the
    prompt loop at the smallest pad_len, which is the same function."""
    cfg, jp, tcfg, tm = _both(tiny, kv_int8)
    mel = tiny[2]
    P = cfg.n_text_ctx // 2 + 1
    buf, plen = _window_prompts(cfg, P, [1, 4, 9], seed=5)
    r = JW.decode_window(jp, jnp.asarray(mel), jnp.asarray(buf), jnp.asarray(plen), cfg, sot_distance=1,
                         max_tokens=12, with_timestamps=with_ts)
    steps = W.DECODE_STEPS["n"]
    g = W.decode_window(tm, torch.from_numpy(mel), buf, plen, tcfg, sot_distance=1, max_tokens=12,
                        with_timestamps=with_ts)
    assert W.DECODE_STEPS["n"] - steps == (P - 8) + 11  # prompt slots from min(pad_len), then 11 steps
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(r[1]))
    _close(g[2], r[2], kv_int8)
    np.testing.assert_allclose(g[3].numpy(), np.asarray(r[3]), rtol=2e-3 if kv_int8 else 1e-5)
    if with_ts:
        assert bool((g[0][:, 0] >= cfg.timestamp_begin).all())


def test_decode_window_best_of_t0_and_padding_invariance(tiny):
    """At T = 0 best_of changes nothing; the same logical prompt decodes
    the same whatever the buffer size (the JAX test's property)."""
    _cfg, _jp, tcfg, tm = _both(tiny, False)
    mel = torch.from_numpy(tiny[2][:1])
    out = []
    for P in (2, 6, 12):
        buf = np.full((1, P), tcfg.eot, np.int32)
        buf[0, P - 2:] = [tcfg.sot, tcfg.no_timestamps]
        out.append(W.decode_window(tm, mel, buf, [2], tcfg, sot_distance=2, max_tokens=6, best_of=3))
    for t, _l, lp, ns in out[1:]:
        assert torch.equal(t, out[0][0])
        assert abs(float(lp[0]) - float(out[0][2][0])) < 1e-4
        assert abs(float(ns[0]) - float(out[0][3][0])) < 1e-6


@pytest.mark.parametrize("case", ["no_timestamps", "first", "later"])
def test_apply_decode_rules_matches_jax(tiny, case):
    """Random logits and random (last_was_ts, penult_was_ts, max_ts)
    states, with logits scaled so that both outcomes of the 'timestamps
    outweigh text' rule occur: identical filtered logits."""
    cfg = tiny[0]
    rng = np.random.RandomState(11)
    B, V = 64, cfg.n_vocab
    logits = (rng.randn(B, V) * rng.uniform(0.5, 6.0, (B, 1))).astype(np.float32)
    logits[: B // 2, cfg.timestamp_begin:] += 3.0
    last = rng.rand(B) < 0.5
    penult = rng.rand(B) < 0.5
    max_ts = rng.randint(0, V - cfg.timestamp_begin, B).astype(np.int32)
    kw = dict(with_timestamps=case != "no_timestamps", is_first=case == "first")
    jkw, tkw = dict(kw), dict(kw)
    if case == "later":
        jkw.update(last_was_ts=jnp.asarray(last), penult_was_ts=jnp.asarray(penult), max_ts=jnp.asarray(max_ts))
        tkw.update(last_was_ts=torch.from_numpy(last), penult_was_ts=torch.from_numpy(penult),
                   max_ts=torch.from_numpy(max_ts.astype(np.int64)))
    ref = np.asarray(JW._apply_decode_rules(jnp.asarray(logits), cfg, **jkw))
    got = W._apply_decode_rules(torch.from_numpy(logits), _port_cfg(cfg), **tkw).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == "later":  # the forcing rule fired on some rows and not on others
        forced = (ref[:, : cfg.timestamp_begin] <= -1e29).all(axis=1)
        assert 0 < forced.sum() < B


def test_best_of_select_matches_jax():
    """Same candidate arrays, ties included: the same picks (lower index)."""
    rng = np.random.RandomState(2)
    B, n, Lt = 4, 5, 7
    tokens = rng.randint(0, 100, (B * n, Lt)).astype(np.int32)
    lengths = rng.randint(1, Lt + 1, B * n).astype(np.int32)
    lp = (-rng.rand(B * n) * 10).astype(np.float32)
    lengths[5:10], lp[5:10] = 3, -2.0  # utterance 1: five equal candidates
    ref = JW._best_of_select(jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(lp), B, n)
    got = W._best_of_select(torch.from_numpy(tokens), torch.from_numpy(lengths), torch.from_numpy(lp), B, n)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_top_k_breaks_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, -1e30, 2.0, 3.0, -1e30, -1e30], [-1e30] * 8], np.float32)
    for k in (2, 3, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = W._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_sampler_follows_softmax_at_t05():
    """Chi-square test of the port's sampler: 40,000 draws at T = 0.5 from
    fixed logits over 16 tokens against softmax(logits / 0.5). With 15
    degrees of freedom the statistic exceeds 50 with probability < 1e-5;
    the returned log probabilities are log_softmax(logits) (not scaled)."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy((rng.randn(16) * 1.5).astype(np.float32))
    rows = 40000
    tok, lp = W._pick(logits.expand(rows, 16), 0.5, W._generator(17, "cpu"))
    p = torch.softmax(logits / 0.5, dim=-1).double().numpy()
    counts = np.bincount(tok.numpy(), minlength=16)
    chi2 = float(((counts - rows * p) ** 2 / (rows * p)).sum())
    assert chi2 < 50.0, (chi2, counts, rows * p)
    np.testing.assert_allclose(lp.numpy(), torch.log_softmax(logits, -1)[tok].numpy(), rtol=0, atol=1e-6)
    # suppressed tokens (-1e30) are never drawn
    masked = logits.clone()
    masked[:8] = -1e30
    tok2, _ = W._pick(masked.expand(rows, 16), 1.0, W._generator(18, "cpu"))
    assert int(tok2.min()) >= 8


# --- host loops, driven by the same scripted decoders ---------------------------


class Recorder:
    """Replays scripted decoder responses and records every call."""

    def __init__(self, respond, batched):
        self.respond, self.batched, self.calls = respond, batched, []

    def __call__(self, mel, buf, plens, temperature, seed):
        buf = np.asarray(buf)
        if self.batched:
            prompts = [[int(t) for t in buf[i][-int(plens[i]):]] for i in range(buf.shape[0])]
        else:
            prompts = [[int(t) for t in buf[0][-int(plens):]]]
        self.calls.append({"width": int(mel.shape[0]), "prompts": prompts, "temperature": temperature, "seed": seed})
        return self.respond(len(self.calls) - 1, int(mel.shape[0]), temperature)


def _script(responses):
    return lambda i, A, temperature: copy.deepcopy(responses[i])


def _rows(tok_lists, lp, nsp=0.0):
    A = len(tok_lists)
    return [list(t) for t in tok_lists], np.full(A, lp, np.float32), np.full(A, nsp, np.float32)


def _same_for(A_tokens, lp=-0.5):
    return lambda i, A, temperature: _rows([A_tokens] * A, lp)


B0, EOT = 100, 2  # tiny_test timestamp_begin and eot
LOOPY = [B0] + [7, 7] * 20 + [B0 + 99]
SCENARIOS = {
    # tests/test_whisper_longform.py:157: seek with last-segment carryover
    "seek_carryover": ([3.0], False, _script([
        ([B0, 10, B0 + 25, B0 + 25, 11, B0 + 50, B0 + 50, 12, B0 + 70], -10.0, 0.0),
        ([B0 + 20, 12, B0 + 45, B0 + 45, 13, B0 + 90, EOT], -10.0, 0.0),
        ([B0, 13, B0 + 50, EOT], -10.0, 0.0)]),
        dict(condition_on_previous_text=True, temperatures=(0.0,), no_speech_threshold=0.6)),
    # :188: conditioning prompt, with and without
    "conditioning": ([3.0], False, _script([
        ([B0, 10, B0 + 25, B0 + 25, 11, B0 + 50], -10.0, 0.0),
        ([B0, 12, B0 + 50, EOT], -10.0, 0.0),
        ([B0, 13, B0 + 9, EOT], -10.0, 0.0)]),
        dict(condition_on_previous_text=True, temperatures=(0.0,))),
    "no_conditioning": ([3.0], False, _script([
        ([B0, 10, B0 + 25, B0 + 25, 11, B0 + 50], -10.0, 0.0),
        ([B0, 12, B0 + 50, EOT], -10.0, 0.0),
        ([B0, 13, B0 + 9, EOT], -10.0, 0.0)]),
        dict(condition_on_previous_text=False, temperatures=(0.0,))),
    # :218: no-speech skip, and kept with strong log probability
    "no_speech_skip": ([6.0], False, _script([
        ([B0, 10, B0 + 99], -1.0, 0.0), ([B0, 66, B0 + 99], -50.0, 0.95), ([B0, 11, B0 + 99, EOT], -1.0, 0.0)]),
        dict(temperatures=(0.0,), no_speech_threshold=0.6, logprob_threshold=-1.0)),
    "no_speech_kept": ([6.0], False, _script([
        ([B0, 10, B0 + 99], -1.0, 0.0), ([B0, 66, B0 + 99], -0.1, 0.95), ([B0, 11, B0 + 99, EOT], -1.0, 0.0)]),
        dict(temperatures=(0.0,), no_speech_threshold=0.6, logprob_threshold=-1.0)),
    # :251: fallback on compression ratio, prompt reset above T = 0.5
    "fallback_reset": ([4.0], False, _script([
        (LOOPY, -0.5, 0.0), (LOOPY, -0.5, 0.0), ([B0, 10, B0 + 99], -0.5, 0.0), ([B0, 11, B0 + 99, EOT], -0.5, 0.0)]),
        dict(temperatures=(0.0, 0.2, 0.6), no_speech_threshold=None)),
    # :327: lockstep rows cost the longest row's window count in calls
    "call_scaling": ([8.0] * 4, True, _same_for([B0, 10, B0 + 99]), dict(temperatures=(0.0,), no_speech_threshold=None)),
    # :354: rows drop out independently
    "rows_independent": ([2.0, 6.0], True, _same_for([B0, 10, B0 + 99]),
                         dict(temperatures=(0.0,), no_speech_threshold=None)),
    # :376: power-of-two widths
    "width_buckets": ([2.0, 2.0, 6.0], True, _same_for([B0, 10, B0 + 99]),
                      dict(temperatures=(0.0,), no_speech_threshold=None)),
    # :407: a retry decodes only the pending rows
    "per_row_fallback": ([2.0, 2.0], True, _script([
        _rows([[B0, 10, B0 + 99], LOOPY], -0.5), _rows([[B0, 11, B0 + 99]], -0.5)]),
        dict(temperatures=(0.0, 0.6), no_speech_threshold=None)),
    # :445: zero advance does not wedge the loop
    "zero_advance": ([4.0], False, _script([([B0, B0], -0.5, 0.0)] * 10),
                     dict(temperatures=(0.0,), no_speech_threshold=None, condition_on_previous_text=False)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_longform_host_loop_matches_jax(tiny, name):
    """transcribe_longform(_batch) of both packages with the same scripted
    decoder: identical segments, texts, seeks, prompts, temperatures and
    seeds of every call."""
    seconds, batched, respond, kw = SCENARIOS[name]
    cfg, params, _ = tiny
    jm = JLoadedModel(JModelType.WHISPER, None, cfg, None)
    pm = from_tree(params, _port_cfg(cfg), device="cpu")
    audios = [np.zeros(int(s * 16000), np.float32) for s in seconds]
    out = []
    for mod, model in ((JWI, jm), (WI, pm)):
        rec = Recorder(respond, batched)
        if batched:
            res = mod.transcribe_longform_batch(model, audios, with_timestamps=True, batch_decode_fn=rec, **kw)
        else:
            res = mod.transcribe_longform(model, audios[0], with_timestamps=True, decode_fn=rec, **kw)
        out.append((res, rec.calls))
    (jres, jcalls), (pres, pcalls) = out
    assert pres == jres
    assert pcalls == jcalls
    texts = [r["text"] for r in (pres if batched else [pres])]
    assert all(isinstance(t, str) for t in texts) and pcalls


def _scripted_fallback(calls):
    """Beam/sample stand-ins of both packages: call n returns token 5+n for
    every row; row 0 passes at once, row 1 on the first retry, row 2 only at
    the last temperature (its text is degenerate until then)."""

    def run(mel, temperature, kind):
        Wd = int(mel.shape[0])
        n = len(calls)
        calls.append({"width": Wd, "temperature": temperature, "kind": kind})
        L = 30
        tokens = np.full((Wd, L), 2, np.int32)
        tokens[:, 0] = 5 + n
        lengths = np.ones(Wd, np.int32)
        lp = np.full(Wd, -0.1, np.float32)
        if n == 0:
            lp[1:] = -50.0
        if n <= 1 and Wd >= 2:
            tokens[-1, :L - 1], lengths[-1] = 9, L - 1  # degenerate repetition: compression ratio fails
        return tokens, lengths, lp

    return run


@pytest.mark.parametrize("beam_size", [0, 5])
def test_fallback_chain_matches_jax(tiny, monkeypatch, beam_size):
    """transcribe_with_fallback of both packages with their beam and sample
    decoders patched to the same scripted outputs (as
    tests/test_whisper_decode.py:85 does): identical texts, the same pending
    rows retried at the same widths and temperatures."""
    cfg, params, _ = tiny
    prompt = [cfg.sot, cfg.no_timestamps]
    jcalls, pcalls = [], []
    jrun, prun = _scripted_fallback(jcalls), _scripted_fallback(pcalls)

    def j_sample(cfg_, prompt_, max_tokens_, temperature, best_of=1):
        return lambda p, mel, k: jrun(mel, temperature, "sample")

    def j_beam(cfg_, prompt_, max_tokens_, beam_size_):
        return lambda p, mel: jrun(mel, 0.0, "beam")

    monkeypatch.setattr(JWI, "_jitted_sample", j_sample)
    monkeypatch.setattr(JWI, "_jitted_beam", j_beam)
    monkeypatch.setattr(W, "sample_decode", lambda m, mel, c, pr, seed, temperature, max_tokens, best_of:
                        tuple(map(torch.from_numpy, prun(mel, temperature, "sample"))))
    monkeypatch.setattr(W, "beam_decode", lambda m, mel, c, pr, beam_size, max_tokens:
                        tuple(map(torch.from_numpy, prun(mel, 0.0, "beam"))))
    kw = dict(max_tokens=30, beam_size=beam_size, temperatures=(0.0, 0.4, 1.0), best_of=5)
    jm = JLoadedModel(JModelType.WHISPER, None, cfg, None)
    ref = JWI.transcribe_with_fallback(jm, jnp.zeros((3, cfg.n_mels, 200)), prompt, **kw)
    got = WI.transcribe_with_fallback(from_tree(params, _port_cfg(cfg), device="cpu"),
                                      torch.zeros(3, cfg.n_mels, 200), prompt, **kw)
    assert got == ref
    assert pcalls == jcalls
    assert [c["width"] for c in pcalls] == [3, 2, 1]
    assert pcalls[0]["kind"] == ("beam" if beam_size else "sample")


# --- the real paths on seeded audio ------------------------------------------


def _tones(seconds, seed):
    """Tones + noise at 16 kHz (the shape of a speech file's spectrum, no
    fixture needed)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    audio = sum(0.1 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) for _ in range(3)) + 0.02 * rng.randn(t.size)
    return audio.astype(np.float32)


@pytest.fixture(scope="module")
def models(tiny):
    cfg, params, _ = tiny
    jm = JLoadedModel(JModelType.WHISPER, jax.tree_util.tree_map(jnp.asarray, params), cfg, None)
    return jm, from_tree(params, _port_cfg(cfg), device="cpu")


def test_longform_real_path_matches_jax(models):
    """The port of tests/test_whisper_longform.py:277 on seeded audio: a
    10 s file (5 tiny_test windows) through the real window decode, T = 0:
    the same segments as JAX's; well-formed and monotonic."""
    jm, pm = models
    audio = _tones(10.0, seed=4)
    kw = dict(with_timestamps=True, condition_on_previous_text=True, temperatures=(0.0,), no_speech_threshold=None)
    ref = JWI.transcribe_longform(jm, audio, **kw)
    got = WI.transcribe_longform(pm, audio, **kw)
    assert got["text"] == ref["text"] and got["segments"]
    assert len(got["segments"]) == len(ref["segments"])
    for g, r in zip(got["segments"], ref["segments"]):
        assert g["tokens"] == r["tokens"] and g["seek"] == r["seek"]
        assert g["start"] == pytest.approx(r["start"]) and g["end"] == pytest.approx(r["end"])
        assert g["avg_logprob"] == pytest.approx(r["avg_logprob"], rel=1e-4)
        assert g["no_speech_prob"] == pytest.approx(r["no_speech_prob"], rel=1e-4)
    starts = [s["start"] for s in got["segments"]]
    assert starts == sorted(starts)
    for s in got["segments"]:
        assert 0.0 <= s["start"] <= s["end"] <= len(audio) / 16000 + 2.0
        assert math.isfinite(s["avg_logprob"]) and 0.0 <= s["no_speech_prob"] <= 1.0


def test_longform_batch_equals_b1(models):
    """The port of tests/test_whisper_longform.py:300 on seeded audio:
    three files of 3, 4.5 and 5 s through the batched seek loop give
    exactly each file's B = 1 result (T = 0)."""
    _jm, pm = models
    audios = [_tones(3.0, 5), _tones(4.5, 6), (np.random.RandomState(0).randn(80000) * 0.05).astype(np.float32)]
    kw = dict(with_timestamps=True, condition_on_previous_text=True, temperatures=(0.0,), no_speech_threshold=None)
    batched = WI.transcribe_longform_batch(pm, audios, **kw)
    for a, got in zip(audios, batched):
        solo = WI.transcribe_longform(pm, a, **kw)
        assert got["text"] == solo["text"]
        assert [s["tokens"] for s in got["segments"]] == [s["tokens"] for s in solo["segments"]]
        assert [s["start"] for s in got["segments"]] == pytest.approx([s["start"] for s in solo["segments"]])
        assert [s["end"] for s in got["segments"]] == pytest.approx([s["end"] for s in solo["segments"]])


def test_transcribe_batch_int4_beam_mixed_lengths_matches_jax(tiny):
    """whisper_transcribe_batch of both packages end to end on tiny_test in
    f32 with int4 weights and int8 K/V caches (what --load_in_4bit loads),
    beam_size=5, short and long (> one window) audio in one batch: the same
    texts at T = 0."""
    cfg, params, _ = tiny
    cfg4 = dataclasses.replace(cfg, kv_int8=True)
    qtree = JQ.quantize_params(params, bits=4)
    jm = JLoadedModel(JModelType.WHISPER, jax.tree_util.tree_map(jnp.asarray, qtree), cfg4, None)
    pm = from_tree(qtree, _port_cfg(cfg4), device="cpu")
    batch = [_tones(4.5, 7), _tones(1.5, 8), _tones(0.6, 9), _tones(2.5, 10)]
    ref = JWI.whisper_transcribe_batch(jm, batch, beam_size=5, max_tokens=6)
    resolve = WI.whisper_transcribe_batch(pm, batch, beam_size=5, max_tokens=6, return_async=True)
    got = resolve()
    assert got == ref and len(got) == 4 and all(got)
