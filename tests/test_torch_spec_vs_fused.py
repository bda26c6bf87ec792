"""``python -m dynamo_tpu_torch.scripts.spec_vs_fused`` against the
reference's ``scripts/spec_vs_fused.py`` on the CPU: the four modes
(baseline, fused ``decode_steps=W``, n-gram speculation at
``spec_tokens=W-1``, both composed) on the three workloads (repetitive,
random, sampled), each ``measure`` of the port on the reference's weights
(``init_params(tiny, PRNGKey(0))``, converted) against the reference's
``measure`` on ``JaxLlmEngine``: every request's output token ids, the
tokens generated, the drafted and accepted counts and the request count
equal; the row's keys are the reference's and its timings positive; the
verdict is the reference's over the same rows."""

import jax
import numpy as np
import pytest

from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.scripts import spec_vs_fused

from tests.torch_script_parity import by_prompt, recording_jax_streams, reference_script

WINDOW = 4
SIZE = dict(osl=16, num_requests=3)
PARAMS = params_from_jax(
    jax.tree.map(np.asarray, jax_llama.init_params(jax_llama.LlamaConfig.tiny(),
                                                   jax.random.PRNGKey(0))), "cpu")
COUNTS = ("tokens", "spec_accepted", "spec_drafted")


@pytest.mark.parametrize("workload", spec_vs_fused.WORKLOADS)
async def test_every_mode_matches_the_reference(workload, monkeypatch):
    reference = reference_script("spec_vs_fused")
    rows = []
    for mode in spec_vs_fused.MODES:
        ref_streams: list = []
        with recording_jax_streams(monkeypatch, ref_streams):
            ref = await reference.measure(mode, WINDOW, workload, **SIZE)
        streams: list = []
        ours = await spec_vs_fused.measure(mode, WINDOW, workload, device="cpu",
                                           params=PARAMS, streams=streams, **SIZE)
        assert set(ours) == set(ref)
        assert (ours["mode"], ours["workload"]) == (mode, workload)
        assert {k: ours[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}, mode
        assert len(streams) == len(ref_streams) == SIZE["num_requests"] + 1
        assert by_prompt(streams) == by_prompt(ref_streams), mode
        assert ours["tok_s"] > 0 and ours["wall_s"] > 0
        rows.append(ours)
    if workload == "sampled":  # draft-ineligible lanes: nothing drafted
        assert all(r["spec_drafted"] == 0 for r in rows)
    else:  # the drafter locks onto the tiny model's periodic output
        assert all(r["spec_accepted"] > 0 for r in rows if r["mode"] in ("spec", "composed"))


async def test_verdict_is_the_reference(monkeypatch):
    """The verdict over a full table equals the reference's over the same
    rows (keys and ratios): the reference's ``amain`` fed rows of known
    tok/s through a stand-in ``measure``."""
    reference = reference_script("spec_vs_fused")
    table = {(m, w): float(3 + 2 * i) for i, (w, m) in enumerate(
        (w, m) for w in spec_vs_fused.WORKLOADS for m in spec_vs_fused.MODES)}

    async def fake_measure(mode, window, workload, **kw):
        return {"mode": mode, "workload": workload, "tok_s": table[(mode, workload)]}

    monkeypatch.setattr(reference, "measure", fake_measure)
    ref = await reference.amain(WINDOW)
    assert spec_vs_fused.verdict(ref["results"]) == ref["verdict"]
