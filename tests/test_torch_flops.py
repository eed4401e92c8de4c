"""The port's utils/flops against ssak_tpu's on the CPU.

The FLOP counters are ssak_tpu's arithmetic line for line and read the
fields the port's configs share with ssak_tpu's, so every count at every
preset of both packages (wav2vec2, Conformer, Whisper) agrees to 1e-12
relative. `peak_flops`, ssak_tpu's `tpu_peak_flops` for the card, reads the
card's name: None on the CPU, 989e12 for an H100 SXM, None with a warning
for a card outside its table."""

import dataclasses
import logging

import pytest
import torch

import ssak_tpu.utils.flops as JF
import ssak_tpu_torch.utils.flops as TF
from ssak_tpu.models import conformer as JC
from ssak_tpu.models import wav2vec2 as JW
from ssak_tpu.models import whisper as JWH
from ssak_tpu_torch.models import conformer as TC
from ssak_tpu_torch.models import wav2vec2 as TW
from ssak_tpu_torch.models import whisper as TWH

REL = 1e-12


def _close(got, want):
    assert want > 0 and abs(got - want) <= REL * want, (got, want)


@pytest.mark.parametrize("preset", sorted(JW.PRESETS))
def test_wav2vec2_counts_match_jax(preset):
    j, t = JW.make_config(preset), TW.make_config(preset)
    for frozen in (True, False):
        _close(TF.wav2vec2_train_flops_per_audio_second(t, frozen), JF.wav2vec2_train_flops_per_audio_second(j, frozen))
    _close(TF.ctc_decode_flops_per_audio_second(t), JF.ctc_decode_flops_per_audio_second(j))
    for seconds in (1.0, 15.0, 140.0):
        for a, b in zip(TF._wav2vec2_fwd_parts(t, seconds), JF._wav2vec2_fwd_parts(j, seconds)):
            _close(a, b)


@pytest.mark.parametrize("preset", sorted(JC.PRESETS))
def test_conformer_counts_match_jax(preset):
    _close(TF.conformer_train_flops_per_audio_second(TC.make_config(preset)),
           JF.conformer_train_flops_per_audio_second(JC.make_config(preset)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("preset", sorted(JWH.PRESETS))
def test_whisper_counts_match_jax(preset, remat):
    j = dataclasses.replace(JWH.make_config(preset), remat=remat)
    t = dataclasses.replace(TWH.make_config(preset), remat=remat)
    for batch, frames, tokens, frac in ((4, 3000, 448, 1.0), (1, 1000, 32, 0.01)):
        _close(TF.whisper_train_flops_per_step(t, TF.WhisperStepShape(batch, frames, tokens), frac),
               JF.whisper_train_flops_per_step(j, JF.WhisperStepShape(batch, frames, tokens), frac))
        _close(TF.whisper_encoder_fwd_flops(t, frames), JF.whisper_encoder_fwd_flops(j, frames))
        _close(TF.whisper_decoder_fwd_flops(t, tokens, frames), JF.whisper_decoder_fwd_flops(j, tokens, frames))
        _close(TF.whisper_decode_flops_per_window(t, frames, 4, tokens),
               JF.whisper_decode_flops_per_window(j, frames, 4, tokens))


def test_peak_flops_reads_the_card_name(monkeypatch, caplog):
    assert TF.peak_flops("cpu") is None and TF.peak_flops(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert TF.peak_flops() is None  # no card: the CPU
    names = {"NVIDIA H100 80GB HBM3": 989e12, "NVIDIA A100-SXM4-80GB": None, "NVIDIA H100 PCIe": None}
    for name, want in names.items():
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, n=name: n)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="ssak_tpu_torch"):
            assert TF.peak_flops("cuda:0") == want
        assert (want is None) == any("no bf16 peak" in r.getMessage() and name in r.getMessage()
                                     for r in caplog.records)
