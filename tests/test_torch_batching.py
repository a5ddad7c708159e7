"""The chunk rule of eval/accuracy.py::batched_reconstruct.

With batch_size None a request is cut into chunks of at most 1024 images
and no chunk is padded beyond what the device layout needs: the images
alone on one device, a multiple of the mesh size on a sharded gan. An
explicit batch_size pads every chunk to it. A z0_fn table longer than a
chunk is cropped to the chunk's rows, so each image keeps its draws
whatever the chunking. Rows of the projection are independent: on the
plain CPU path an image's answers in a one-image request are its answers
inside a 256-image call, to float32 summation order at another row
count.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from defensegan_torch.configs import Config
from defensegan_torch.defense.pipeline import DefendedPipeline
from defensegan_torch.eval.accuracy import batched_reconstruct
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models import build_classifier
from defensegan_torch.parallel import ShardedDefenseGAN, make_mesh

torch.set_num_threads(2)

RR, LATENT = 2, 8


class StubGAN:
    """Records the rows and the draws each reconstruct call is handed."""

    def __init__(self, devices=1):
        self.device = torch.device("cpu")
        if devices > 1:
            self.mesh = make_mesh(devices=["cpu"] * devices)
        self.calls = []

    def reconstruct(self, x, gen=None, z0=None, **kw):
        self.calls.append((x, z0))
        return SimpleNamespace(rows=x.shape[0])


def _chunks(gan, n, **kw):
    x = np.arange(1, n + 1, dtype=np.float32)[:, None]
    spans = [(lo, hi) for _, lo, hi in batched_reconstruct(gan, x, **kw)]
    return x, spans, [c[0] for c in gan.calls], [c[1] for c in gan.calls]


@pytest.mark.parametrize("n, rows", [
    (1, [1]), (48, [48]), (255, [255]), (256, [256]), (1000, [1000]),
    (1024, [1024]), (10000, [1024] * 9 + [784])])
def test_chunk_rows_are_the_images_alone(n, rows):
    x, spans, xs, _ = _chunks(StubGAN(), n)
    assert [b.shape[0] for b in xs] == rows
    assert spans == [(lo, lo + r) for lo, r in zip(np.cumsum([0] + rows),
                                                   rows)]
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)


@pytest.mark.parametrize("n, rows", [(1, [256]), (300, [256, 256])])
def test_explicit_batch_size_still_pads_every_chunk(n, rows):
    x, spans, xs, _ = _chunks(StubGAN(), n, batch_size=256)
    assert [b.shape[0] for b in xs] == rows
    assert spans == [(0, min(n, 256))] + ([(256, n)] if n > 256 else [])
    got = torch.cat([b[:hi - lo] for b, (lo, hi) in zip(xs, spans)])
    np.testing.assert_array_equal(got.numpy(), x)
    assert not xs[-1][n - spans[-1][0]:].any()


@pytest.mark.parametrize("n, rows", [(1, [4]), (6, [8]), (1027, [1024, 4])])
def test_sharded_gan_gets_rows_rounded_to_its_devices(n, rows):
    x, spans, xs, _ = _chunks(StubGAN(devices=4), n)
    assert [b.shape[0] for b in xs] == rows
    assert all(not b[hi - lo:].any() for b, (lo, hi) in zip(xs, spans))


def test_z0_table_is_cropped_to_the_chunk():
    table = torch.randn(1300, RR, LATENT)
    gan = StubGAN()
    _, spans, _, z0s = _chunks(gan, 1030, z0_fn=lambda lo: table[lo:])
    assert [tuple(z.shape) for z in z0s] == [(1024, RR, LATENT),
                                             (6, RR, LATENT)]
    for z, (lo, hi) in zip(z0s, spans):
        assert torch.equal(z, table[lo:hi])
    gan = StubGAN()
    _chunks(gan, 1, z0_fn=lambda lo: table[:256])
    assert torch.equal(gan.calls[0][1], table[:1])


def _tiny_gan(tmp_path):
    return DefenseGAN(Config(type="mnist", gen_arch="wide", gen_dim=4,
                             disc_dim=4, latent_dim=LATENT, rec_rr=RR,
                             rec_iters=4, compute_dtype="float32",
                             output_dir=str(tmp_path)), device="cpu")


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def test_sharded_gan_serves_a_one_image_request(tmp_path):
    """A real four-shard gan accepts the rounded rows (its reconstruct
    validates the sharding) and returns the image's own row."""
    sharded = ShardedDefenseGAN(_tiny_gan(tmp_path),
                                make_mesh(devices=["cpu"] * 4))
    table = torch.randn(256, RR, LATENT)
    (res, lo, hi), = batched_reconstruct(sharded, _images(1, 0),
                                         z0_fn=lambda lo: table[lo:])
    assert (lo, hi) == (0, 1) and res.x_hat.shape == (4, 28, 28, 1)
    assert torch.isfinite(res.loss).all()


def test_one_image_request_equals_it_inside_a_256_batch(tmp_path):
    """Plain CPU path, the same draws: an image's prediction and flag in a
    one-image DefendedPipeline.predict equal its own inside a 256-image
    call; its losses, x_hat and margin agree to float32 summation order
    at another row count (tests/test_torch_project.py's plain-path bounds:
    losses rtol 1e-3, x_hat atol 1e-3, equal argmins;
    tests/test_torch_pipeline.py's 1e-4 on logits, 1e-2 relative on the
    dispersion)."""
    gan = _tiny_gan(tmp_path)
    clf = build_classifier("E", gen=torch.Generator().manual_seed(3))
    pipe = DefendedPipeline(gan, clf.requires_grad_(False), fpr=0.5)
    table = torch.randn(256 + 8, RR, LATENT,
                        generator=torch.Generator().manual_seed(1))
    calib = torch.randn(256, RR, LATENT,
                        generator=torch.Generator().manual_seed(2))
    pipe.calibrate(_images(256, 1), batch_size=256,
                   z0_fn=lambda p, lo: calib[lo:])
    x = _images(200, 2)
    full = pipe.predict(x, batch_size=256, z0_fn=lambda p, lo: table[lo:])
    (big, _, _), = batched_reconstruct(gan, x, batch_size=256,
                                       z0_fn=lambda lo: table[lo:])
    for j in (0, 77, 199):
        one = pipe.predict(x[j:j + 1], z0_fn=lambda p, lo: table[j + lo:])
        np.testing.assert_array_equal(one.pred, full.pred[j:j + 1])
        np.testing.assert_array_equal(one.flagged, full.flagged[j:j + 1])
        np.testing.assert_allclose(one.rec_err, full.rec_err[j:j + 1],
                                   rtol=1e-3)
        np.testing.assert_allclose(one.margin, full.margin[j:j + 1],
                                   atol=1e-4)
        np.testing.assert_allclose(one.dispersion,
                                   full.dispersion[j:j + 1], rtol=1e-2)
        (res, _, _), = batched_reconstruct(gan, x[j:j + 1],
                                           z0_fn=lambda lo: table[j + lo:])
        assert res.x_hat.shape[0] == 1
        np.testing.assert_allclose(res.all_losses[0], big.all_losses[j],
                                   rtol=1e-3)
        assert torch.equal(res.all_losses[0].argmin(),
                           big.all_losses[j].argmin())
        np.testing.assert_allclose(res.x_hat[0], big.x_hat[j], atol=1e-3)
    assert full.flagged.any() and not full.flagged.all()
