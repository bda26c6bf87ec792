"""Speculative decoding on MoE engine meshes, against the reference's: the
port's Mixtral and DeepSeek engines at tp x ep = 2 x 2 (rank 0 here, the
shard workers child processes) with ``speculative="ngram"``, greedy and
seeded streams equal to ``JaxLlmEngine``'s on the same mesh and to the
port's one-card engine's, with equal drafted and accepted counts, at a
capacity factor that drops routed pairs (the verify window's b * w tokens
route position-major, the capacity from the global counts, on every
rank).  The dense cases and the verify forwards:
``tests/test_torch_mesh_spec.py``."""

import pytest

from tests.test_torch_mesh_spec import check_speculative_streams


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_moe_speculative_streams_match_the_reference_mesh_engine(name):
    check_speculative_streams(name, dict(tp=2, ep=2))
