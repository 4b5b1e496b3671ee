"""Tokens of every training step finished in the window, over the
window's seconds (host clock)."""


def read(rec, model, mix):
    if not getattr(rec, "steps", None) or rec.window_s <= 0:
        return None
    return sum(s.tokens for s in rec.steps) / rec.window_s
