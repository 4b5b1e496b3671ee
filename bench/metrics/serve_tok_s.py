"""Prompt plus generated tokens of every request finished in the window,
over the window's seconds (host clock)."""


def read(rec, model, mix):
    if not getattr(rec, "waves", None) or rec.window_s <= 0:
        return None
    toks = sum(sum(w.prompt_lens) + sum(w.new_tokens) for w in rec.waves)
    return toks / rec.window_s
