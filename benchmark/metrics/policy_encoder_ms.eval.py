"""Mean host time a step inside the program's ``policy.encoder`` span
(``models/policy.py::_ActorCritic.forward``: the 2x2 pool, the backbone,
the compression, ``visual_fc`` and the embeddings), outside the traced
steps: the enqueue of the policy's visual encoder.  None where the program
has no such span."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or "policy.encoder" not in w.spans:
        return None
    return w.ms_per_step("policy.encoder")
