"""95th percentile over every request of the window of the time from its
submission to its first token on the host, both on the harness's clock
(the percentile's arithmetic is that of repro_torch/serve/harness.py)."""

import numpy as np


def read(rec, model, mix):
    if not getattr(rec, "waves", None):
        return None
    ttft = [w.t_first - w.t_submit for w in rec.waves for _ in w.rids]
    return 1e3 * float(np.percentile(np.asarray(ttft, np.float64), 95))
