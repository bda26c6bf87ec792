"""``python -m dynamo_tpu_torch.scripts.profile_decode`` against the
reference's ``scripts/profile_decode.py`` on the CPU, at the tiny model with
zero speedup floors (as tests/bench/test_profile_decode_*.py run the
reference): the overlap A/B, a single forced-sync run, and the mixed A/B on
the llama, moe and mla families and decode-heavy.  For each mode both
scripts serve the same prompts, and the port's streams (output token ids)
and stream-derived counts (requests, tokens) equal the reference's on
``JaxLlmEngine``; the JSON keys and decode phase names are the reference's,
timing fields positive, and a unified run drains nothing on admission."""

from types import SimpleNamespace

import pytest

from dynamo_tpu_torch.scripts import profile_decode

from tests.torch_script_parity import by_prompt, recording_jax_streams, reference_script

# each run's timing fields, positive in both scripts
TIMING_KEYS = ("wall_s", "tok_s", "steps_s")


def ab_args(**overrides) -> SimpleNamespace:
    defaults = dict(
        model="tiny", quant="none", kv_dtype="bf16", isl=32, osl=12,
        batch=4, decode_steps=2, overlap=None, ab=True,
        ab_min_speedup=0.0, out=None, device="cpu",
    )
    defaults.update(overrides)
    return SimpleNamespace(**defaults)


def mixed_args(**overrides) -> SimpleNamespace:
    defaults = dict(
        model="tiny", quant="none", kv_dtype="bf16", isl=32, osl=10,
        batch=4, decode_steps=1, overlap=None, ab=False,
        ab_min_speedup=0.0, mixed=True, mixed_min_speedup=0.0,
        requests=6, arrival_ms=30, chunk=16, out=None,
        family="llama", decode_heavy=False, device="cpu",
    )
    defaults.update(overrides)
    return SimpleNamespace(**defaults)


@pytest.fixture
def reference(monkeypatch):
    """The reference script, imported with phase timing on (its import sets
    the knob; monkeypatch takes it back after the test)."""
    monkeypatch.setenv("DYN_ENGINE_PHASE_TIMING", "1")
    return reference_script("profile_decode")


async def both(reference, monkeypatch, args):
    """(reference rc, result, streams), (port rc, result, streams by mode)."""
    ref_streams: list = []
    with recording_jax_streams(monkeypatch, ref_streams):
        ref_rc, ref = await reference.amain(args)
    ours_streams: dict = {}
    rc, ours = await profile_decode.amain(args, streams=ours_streams)
    return (ref_rc, ref, ref_streams), (rc, ours, ours_streams)


def assert_same_keys(ours: dict, ref: dict, runs: tuple[str, ...]):
    assert set(ours) == set(ref)
    for mode in runs:
        assert set(ours[mode]) == set(ref[mode]), mode
        for key in TIMING_KEYS:
            assert ours[mode][key] > 0, (mode, key)
        assert set(ours[mode]["decode_phase_share"]) == set(ref[mode]["decode_phase_share"])
        assert all(k.startswith("decode.") for k in ours[mode]["decode_phase_share"])


def assert_same_streams(ref_streams: list, ours_streams: dict, modes: tuple[str, ...]):
    """The reference ran its modes in order, so its streams split at each
    mode's request count; each mode's streams equal the port's."""
    start = 0
    for mode in modes:
        mine = ours_streams[mode]
        theirs = ref_streams[start:start + len(mine)]
        start += len(mine)
        assert len(theirs) == len(mine), mode  # requests
        assert by_prompt(mine) == by_prompt(theirs), mode  # prompts and token ids
        assert sum(map(len, (t for _, t in mine))) == sum(map(len, (t for _, t in theirs)))
    assert start == len(ref_streams)


async def test_overlap_ab_matches_the_reference(reference, monkeypatch):
    (ref_rc, ref, ref_streams), (rc, ours, streams) = await both(
        reference, monkeypatch, ab_args())
    assert rc == ref_rc == 0
    assert_same_keys(ours, ref, ("sync", "overlap"))
    assert_same_streams(ref_streams, streams, ("sync", "overlap"))
    assert ours["sync"]["overlap"] is False and ours["overlap"]["overlap"] is True
    assert ours["sync"]["windows_overlapped"] == 0
    assert ours["overlap"]["windows_overlapped"] > 0
    # the overlapped pipeline has no synchronous readback phase: the wait
    # moved to decode.retire, behind the next window
    assert ours["readback_share_overlap"] == 0.0 < ours["readback_share_sync"]
    assert ours["overlap_speedup_tok_s"] > 0.0
    for mode in ("sync", "overlap"):
        assert ours[mode]["itl_mean_ms"] > 0


async def test_single_mode_matches_the_reference(reference, monkeypatch):
    """--overlap 0 forces the synchronous path in a plain (non-A/B) run."""
    args = ab_args(ab=False, overlap=0, osl=8)
    (ref_rc, ref, ref_streams), (rc, ours, streams) = await both(reference, monkeypatch, args)
    assert rc == ref_rc == 0
    assert set(ours) == set(ref)
    assert ours["overlap"] is False and ours["windows_overlapped"] == 0
    assert set(ours["decode_phase_share"]) == set(ref["decode_phase_share"])
    assert_same_streams(ref_streams, streams, ("sync",))


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(family="moe", isl=16, osl=6, requests=4),
    dict(family="mla", isl=16, osl=6, requests=4),
    dict(decode_heavy=True, osl=16, requests=4),
], ids=["llama", "moe", "mla", "decode_heavy"])
async def test_mixed_ab_matches_the_reference(reference, monkeypatch, overrides):
    args = mixed_args(**overrides)
    (ref_rc, ref, ref_streams), (rc, ours, streams) = await both(reference, monkeypatch, args)
    assert rc == ref_rc == 0
    assert_same_keys(ours, ref, ("split", "unified"))
    assert_same_streams(ref_streams, streams, ("split", "unified"))
    for key in ("model", "family", "decode_heavy"):
        assert ours[key] == ref[key]
    assert ours["split"]["mode"] == "split" and ours["unified"]["mode"] == "unified"
    # the unified engine served mixed windows, and admission never drained it
    assert ours["windows_unified"] > 0 and ours["split"]["windows_unified"] == 0
    assert ours["admission_drains_unified"] == ref["admission_drains_unified"] == 0
    assert ours["unified_speedup_steps_s"] > 0.0
