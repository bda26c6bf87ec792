"""Fixture: the registry whose ``forward_*`` / ``embed`` keywords name the
graph roots (the pass reads the keywords, never imports this)."""
from models import bad, good


class ModelFamily:
    def __init__(self, **fields):
        self.fields = fields


FAMILIES = {
    "bad": ModelFamily(forward_decode=bad.step, forward_unified=bad.unified,
                       embed=bad.embed, load_weights=bad.load),
    "good": ModelFamily(forward_decode=good.step, forward_prefill=good.prefill),
}
