"""Share of the traced window in which the card idled while the host was in
the policy's spans: ``policy`` (in ``rl/eval.py::fused_vo_act_step``: the
forward, the action and its log-prob) and, inside the forward
(``models/policy.py::_ActorCritic.forward``), ``policy.encoder``,
``policy.rnn`` and ``policy.heads``.  None where the program has no
``policy.encoder`` span."""

from benchmark.metrics import _tracer


def read(ctx):
    w = _tracer.window(ctx)
    if w is None or "policy.encoder" not in w.spans:
        return None
    return _tracer.idle_pct(ctx, ("policy", "policy.encoder", "policy.rnn", "policy.heads"))
