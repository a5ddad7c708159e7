"""Fixtures of the benchmark's tests (benchmark/tests/).

`bench_tiny.tiny` cuts a deep configuration to two levels of 16 and 8
channels, the program's MNIST stack at GEN_DIM 8. A stack of more levels
(the 64x64 `celeba`, four) keeps its count here, each level half the one
before down to 8 channels: what the program builds at that GEN_DIM.
"""

import pytest


@pytest.fixture(autouse=True)
def tiny_keeps_levels(monkeypatch):
    import bench_tiny
    from benchmark import spec

    cut = bench_tiny.tiny

    def tiny(config, images_per_request, mp, **kw):
        levels = len(spec.config(bench_tiny.BENCH, config)["generator"]
                     ["channels"])
        conf = cut(config, images_per_request, mp, **kw)
        if levels > 2:
            conf["generator"]["channels"] = [8 << (levels - 1 - i)
                                             for i in range(levels)]
        return conf

    monkeypatch.setattr(bench_tiny, "tiny", tiny)
