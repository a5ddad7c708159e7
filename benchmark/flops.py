"""The work of projecting one image, from the shapes: the generator's own
work in each projection step, and under encoder init the encoder's
forward pass once an image.

One step of the projection is the generator's forward pass and its
gradient with respect to the input: 2 FLOPs a multiply-add each way, so 4
per multiply-add of the forward pass. The multiply-adds counted are the
function's own: the fc layer's k x (hw * hw * c0), and for every 5x5
stride-2 SAME transpose convolution only the products that land inside
its output (input pixel i and tap m meet output lo + s*i - m; the others
fall on the crop). Never counted: the dense matrix that the wide
generator's deconv is packed into (its structural zeros), the
space-to-depth form's zero taps, or a kernel's padding of rows, columns
and tiles. The arithmetic is that of the repository's `chip_smoke.py::
deconv_macs` / `bounds_v3`, extended to the wide generator.

The encoder's forward counts 2 FLOPs a multiply-add, and of each SAME
stride-s convolution only the products that read inside its input (output
pixel o and tap m read input s*o + m - lo; the others read the padding),
then the dense layer.
"""

from __future__ import annotations

from typing import Optional

from benchmark.reference.classifier import same_pads
from benchmark.reference.encoder import EncoderShape
from benchmark.reference.generator import GeneratorShape, transpose_pads


def deconv_macs(h: int, cin: int, cout: int, k: int = 5, s: int = 2) -> int:
    """Multiply-adds of one SAME stride-s k x k transpose conv on an h x h
    input that land inside its (s*h) x (s*h) output."""
    lo, _ = transpose_pads(k, s)
    per_axis = sum(1 for i in range(h) for m in range(k)
                   if 0 <= lo + s * i - m < s * h)
    return per_axis * per_axis * cin * cout


def forward_macs(shape: GeneratorShape) -> int:
    """Multiply-adds of one forward pass of one latent row."""
    hw, chans = shape.base_hw, list(shape.channels) + [shape.out_channels]
    macs = shape.latent_dim * hw * hw * chans[0]
    for i in range(len(chans) - 1):
        macs += deconv_macs(hw * shape.stride ** i, chans[i], chans[i + 1],
                            shape.kernel, shape.stride)
    return macs


def step_flops(shape: GeneratorShape) -> int:
    """FLOPs of one projection step of one latent row: forward and input
    gradient."""
    return 4 * forward_macs(shape)


def dense_form_flops(shape: GeneratorShape) -> int:
    """What the wide generator's dense packing issues a row-step (fc, and
    the deconv as a dense [hw*hw*c0, out_dim] matrix), for contrast only:
    never the benchmark's count."""
    if len(shape.channels) != 1:
        raise ValueError("the dense form packs single-deconv generators")
    feat = shape.base_hw ** 2 * shape.channels[0]
    return 4 * (shape.latent_dim * feat + feat * shape.out_dim)


def conv_macs(h: int, cin: int, cout: int, k: int = 5, s: int = 2) -> int:
    """Multiply-adds of one SAME stride-s k x k convolution on an h x h
    input that read inside it."""
    lo, _ = same_pads(h, k, s)
    per_axis = sum(1 for o in range(-(-h // s)) for m in range(k)
                   if 0 <= s * o + m - lo < h)
    return per_axis * per_axis * cin * cout


def encoder_macs(enc: EncoderShape) -> int:
    """Multiply-adds of the encoder's forward pass on one image."""
    hw, cin, macs = enc.image_size, enc.in_channels, 0
    for c in enc.channels:
        macs += conv_macs(hw, cin, c, enc.kernel, enc.stride)
        hw, cin = -(-hw // enc.stride), c
    return macs + enc.features * enc.z_dim


def image_flops(shape: GeneratorShape, restarts: int, iters: int,
                encoder: Optional[EncoderShape] = None) -> int:
    """The work to project one image: the generator's R restarts x L
    steps, and the encoder's forward once where it starts restart 0."""
    total = restarts * iters * step_flops(shape)
    if encoder is not None:
        total += 2 * encoder_macs(encoder)
    return total
