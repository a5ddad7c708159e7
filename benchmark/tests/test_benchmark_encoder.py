"""An encoder-initialised projection (`projection.init` "encoder"): the
plain encoder against the program's, and a tiny encoder cell served and
judged on the CPU. The program does not yet start restart 0 at its own
E(x) under given draws; bench_tiny.encoder_stand_in stands in for that
change, and the program as it stands must come out not correct."""

import types

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import check, harness, spec, weights
from benchmark.reference.encoder import EncoderShape, encode, weight_shapes
from benchmark.system import _nested
from bench_tiny import BENCH

CELLS = ["mnist_fast.bulk10k", "mnist_fast.serve1"]


def images(cell):
    return 8 if spec.cell(BENCH, cell)["traffic"].startswith("bulk") else 1


@pytest.mark.parametrize("dataset,shape", [
    ("mnist", EncoderShape((8, 16), 16, 1, 28)),
    ("celeba", EncoderShape((8, 16, 32, 64), 16, 3, 64))])
def test_reference_encoder_matches_the_program(dataset, shape):
    """reference/encoder.py against the port's Encoder, both float32, on
    seeded kernels and drawn biases (seeded biases are zero)."""
    from defensegan_torch.ckpt.bridge import load_flax_tree
    from defensegan_torch.models.encoder import encoder_for
    dev = torch.device("cpu")
    w = weights.seeded(weight_shapes(shape), 7, dev)
    gen = torch.Generator().manual_seed(8)
    for p in w:
        if p.endswith("/bias"):
            w[p] = 0.1 * torch.randn(w[p].shape, generator=gen)
    enc = encoder_for(dataset, 8, z_dim=shape.z_dim)
    load_flax_tree(enc, _nested(w)[0])
    hw = shape.image_size
    x = 2.0 * torch.rand(4, hw, hw, shape.in_channels, generator=gen) - 1.0
    want = enc(x)
    got = encode(w, shape, x)
    assert got.shape == (4, shape.z_dim) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_encoder_cell_with_the_stand_in_is_correct(cell, monkeypatch):
    """A configuration that states the encoder start is served and judged
    by the harness as it is, once the program starts restart 0 at E(x)
    (here the stand-in)."""
    bench_tiny.tiny_encoder(images(cell), monkeypatch)
    bench_tiny.encoder_stand_in(monkeypatch)
    out = bench_tiny.run(cell)
    assert out["correct"], out["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_that_projects_the_table_whole_is_not_correct(cell,
                                                              monkeypatch):
    """The program as it stands reads restart 0's NaN slot in place of
    E(x): a result line with correct false, not an exception."""
    bench_tiny.tiny_encoder(images(cell), monkeypatch)
    out = bench_tiny.run(cell)
    assert not out["correct"]
    gap = out["checked"]["restart_gap_p25"]["value"]
    assert gap != gap, out["checked"]           # NaN


def _relu_encoder(monkeypatch):
    from defensegan_torch.models import encoder
    monkeypatch.setattr(encoder, "F", types.SimpleNamespace(
        leaky_relu=lambda h, slope: torch.relu(h)))


def _encoder_from_another_seed(monkeypatch):
    real = harness.ProgramSystem

    def system(conf, gen_w, clf_w, device, recorder, enc_w):
        other = weights.seeded({p: tuple(t.shape) for p, t in enc_w.items()},
                               12345, device)
        return real(conf, gen_w, clf_w, device, recorder, other)

    monkeypatch.setattr(harness, "ProgramSystem", system)


@pytest.mark.parametrize("fault,caught_by", [
    (_relu_encoder, "restart_far_pct"),
    (_encoder_from_another_seed, "restart_far_pct")],
    ids=["relu_for_leaky_relu", "encoder_weights_of_another_seed"])
def test_wrong_encoder_start_is_not_correct(fault, caught_by, monkeypatch):
    """The stand-in with a wrong E(x): restart 0 starts elsewhere than the
    reference's, and the far share of (image, restart) pairs sees it."""
    bench_tiny.tiny_encoder(8, monkeypatch)
    bench_tiny.encoder_stand_in(monkeypatch)
    fault(monkeypatch)
    out = bench_tiny.run("mnist_fast.bulk10k")
    assert not out["correct"]
    c = out["checked"][caught_by]
    assert c["value"] > c["limit"], out["checked"]


def test_random_init_projects_the_table_itself(monkeypatch):
    """With `init` absent the table holds draws only and the check projects
    it as it is; under encoder init restart 0 is NaN and the other
    restarts keep the same draws."""
    conf = bench_tiny.tiny("mnist_fast", 8, monkeypatch)
    assert "init" not in conf["projection"]
    traffic = spec.traffic("bulk10k")
    dev = torch.device("cpu")
    plain = harness.Inputs(conf, traffic, 2 ** 31 + 9, dev)
    table = plain.table(3, 8)
    assert plain.encoder is None and plain.enc_w is None
    assert not torch.isnan(table).any()
    assert not torch.isnan(plain.z0_calib).any()
    x = torch.as_tensor(plain.pool[:8])
    calls = []
    monkeypatch.setattr(check, "encoder_starts",
                        lambda *a, **k: calls.append(a))
    seen = []
    real = check._project_blocks
    monkeypatch.setattr(check, "_project_blocks",
                        lambda gen, x, z0, pr, block: seen.append(z0)
                        or real(gen, x, z0, pr, block))
    s = check.Sample(x=x, z0=table[:8], all_losses=torch.ones(8, 2),
                     z_star=table[:8, 0], x_hat=x, pred=np.zeros(8),
                     flagged=np.zeros(8, bool), rec_err=np.ones(8),
                     margin=np.ones(8))
    z0_calib = plain.z0_calib[:plain.x_calib.shape[0]]
    check.reference_numbers(conf, plain.gen_w, plain.clf_w,
                            torch.as_tensor(plain.x_calib), z0_calib, s)
    assert not calls and seen[0] is z0_calib and seen[1] is s.z0

    enc_conf = bench_tiny.tiny_encoder(8, monkeypatch)
    enc = harness.Inputs(enc_conf, traffic, 2 ** 31 + 9, dev)
    enc_table = enc.table(3, 8)
    assert enc_table.shape == table.shape
    assert torch.isnan(enc_table[:, 0]).all()
    assert torch.equal(enc_table[:, 1:], table[:, 1:])
