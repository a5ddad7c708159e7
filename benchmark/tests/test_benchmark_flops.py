"""The generator's own work a row-step: the wide generator's 3.786 MFLOP
and the deep one's 37.91, never the dense form's 22.88; under encoder
init the encoder's forward once an image (mnist_fast's: 18.96 MFLOP)."""

import pytest

from benchmark import flops
from benchmark.check import encoder_of, shape_of
from bench_tiny import configs


@pytest.mark.parametrize("name,mflop", [("mnist_fast", 3.785856),
                                        ("mnist", 37.91488)])
def test_step_flops(name, mflop):
    assert flops.step_flops(shape_of(configs()[name])) == \
        pytest.approx(mflop * 1e6, abs=0.5)


def test_wide_counts_the_function_not_the_dense_form():
    shape = shape_of(configs()["mnist_fast"])
    # fc 128 x 6272 and the deconv's 67^2 x 32 products inside the output
    assert flops.forward_macs(shape) == 128 * 6272 + 67 * 67 * 32
    assert flops.dense_form_flops(shape) == pytest.approx(22.880256e6)
    assert flops.step_flops(shape) < flops.dense_form_flops(shape) / 6


def test_deconv_macs_keep_only_products_inside_the_output():
    # 7 -> 14: each axis 4 + 5 * 5 + 3 = 32 tap hits (3 cropped at each
    # border); a full 5 x 5 per input pixel would be 35
    assert flops.deconv_macs(7, 1, 1) == 32 * 32
    assert flops.deconv_macs(14, 2, 3) == 67 * 67 * 6


def test_image_flops():
    shape = shape_of(configs()["mnist_fast"])
    assert flops.image_flops(shape, 10, 200) == 2000 * \
        flops.step_flops(shape)


def _with_encoder(conf):
    return dict(conf, projection=dict(conf["projection"], init="encoder"),
                encoder={"channels": [64, 128], "kernel": 5, "stride": 2,
                         "z_dim": 128, "negative_slope": 0.2})


def test_encoder_counts_only_products_inside_its_input():
    enc = encoder_of(_with_encoder(configs()["mnist_fast"]))
    # 28 -> 14: 4 + 12 * 5 + 3 = 67 taps an axis; 14 -> 7: 4 + 5 * 5 + 3
    assert flops.conv_macs(28, 1, 64) == 67 * 67 * 64 == 287_296
    assert flops.conv_macs(14, 64, 128) == 32 * 32 * 64 * 128 == 8_388_608
    assert flops.encoder_macs(enc) == 287_296 + 8_388_608 + 802_816


def test_image_flops_add_the_encoder_once_under_encoder_init():
    conf = configs()["mnist_fast"]
    shape = shape_of(conf)
    assert encoder_of(conf) is None
    generator = flops.image_flops(shape, 2, 50)
    assert generator == 100 * flops.step_flops(shape) == 378_585_600
    enc = encoder_of(_with_encoder(conf))
    assert flops.image_flops(shape, 2, 50, enc) == \
        generator + 2 * 9_478_720 == 397_543_040
