"""Percent of the training step spent in ``torch.autograd.grad`` (the
checkpointed bounces' recompute and the hit recompute), from the
harness's spans around ``frame_loss`` and ``torch.autograd.grad``, each
ended by a synchronize, over the window of a ``--trace 1`` run (whose
steps are run as those two calls)."""


def read(ctx):
    f, b = ctx["spans"].get("forward_s", 0.0), ctx["spans"].get(
        "backward_s", 0.0)
    return None if f + b <= 0 else 100.0 * b / (f + b)
