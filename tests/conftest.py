"""Registers the marker of tests that need an NVIDIA card, and the
fixture that takes the decode graph's route on the CPU."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def graph_stand_in(monkeypatch):
    """The decode graph's route taken on the CPU, by a runner whose capture
    and replay run the eager step on its static buffers: the runner's
    binding, generations and spans without a card."""
    import torch

    from repro_torch.models import decode_graph

    class EagerRunner(decode_graph.DecodeGraph):
        def _record(self, body, pos):
            self.body, self.pos = body, pos
            self.graph = "eager"

        def _replay(self):
            self.logits, _ = self.body(self.tokens, self._cache(self.pos))

    route = decode_graph.takes_graph
    monkeypatch.setattr(decode_graph, "takes_graph", lambda devices, *a:
                        route((torch.device("cuda"),), *a))
    monkeypatch.setattr(decode_graph, "DecodeGraph", EagerRunner)
