"""The system under test: `defensegan_torch`'s DefendedPipeline, built as
an operator builds it (DefenseGAN, classifier, pipeline, calibration),
with the benchmark's one pass-through around `DefenseGAN.reconstruct`.

The pass-through (Recorder.wrap) hands each projection chunk the
benchmark's restart draws: `z0_fn(pass, lo)` gives the request's table
from row `lo` on, and the pass-through keeps the rows the chunk takes,
however the program cuts and pads a request. It counts the rows and the
calls by the projection path that ran, keeps the chunk's result for the
requests the check samples, and in the traced run opens a profiler range
around the call.

Encoder init (a configuration whose `projection.init` is "encoder", its
`encoder` block the encoder's shape): the program's encoder is built as
DefenseGAN.load builds it (encoder_for(cfg.type, cfg.disc_dim, z_dim=
cfg.latent_dim, dtype=the program's compute dtype)), held to the stated
channels, kernel, z_dim, input channels and image size (the last through
the dense layer's input width; a mismatch raises, as a generator's
does), loaded with the benchmark's weights (load_flax_tree, then
weights_changed), and the pipeline is built with rec_init="encoder".
The draws handed to reconstruct then hold NaN in restart 0: the program
is to start restart 0 at its own E(x) and restarts 1..R-1 at z0[:, 1:].
A program that reads the table whole projects NaN and fails the check.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark import tracing
from benchmark.check import encoder_of
from benchmark.spec import ROOT


def _nested(tree: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """`<layer>/<leaf>` tensors -> flax (params, batch_stats) trees of
    numpy arrays."""
    params: Dict = {}
    stats: Dict = {}
    for path, t in tree.items():
        layer, leaf = path.split("/")
        dest = stats if leaf in ("mean", "var") else params
        dest.setdefault(layer, {})[leaf] = t.detach().float().cpu().numpy()
    return params, stats


class Recorder:
    """The benchmark's view of one request's projection chunks."""

    def __init__(self):
        self.table: Optional[torch.Tensor] = None   # z0 rows [rows, R, k]
        self.lo = 0
        self.keep = False
        self.traced = False
        self.chunks: List[tuple] = []    # (lo, rows, result) when kept
        self.rows = 0                    # rows handed to reconstruct
        self.paths: collections.Counter = collections.Counter()  # run-long

    def start(self, table: torch.Tensor, keep: bool) -> None:
        self.table, self.keep = table, keep
        self.chunks, self.rows = [], 0

    def z0_fn(self, pass_index: int, lo: int) -> torch.Tensor:
        self.lo = lo
        return self.table[lo:]

    def wrap(self, inner, path_of: Callable[[], str]):
        def reconstruct(x, gen=None, **kw):
            if kw.get("z0") is not None:
                if kw["z0"].shape[0] < x.shape[0]:
                    raise ValueError(
                        f"a chunk of {x.shape[0]} rows at {self.lo} runs "
                        f"past the request's {self.table.shape[0]} draws")
                kw["z0"] = kw["z0"][:x.shape[0]]
            if self.traced:
                with torch.profiler.record_function(tracing.RECONSTRUCT):
                    res = inner(x, gen, **kw)
            else:
                res = inner(x, gen, **kw)
            self.rows += x.shape[0]
            self.paths[path_of()] += 1
            if self.keep:
                self.chunks.append((self.lo, x.shape[0], res))
            return res
        return reconstruct


class ProgramSystem:
    """DefendedPipeline over a DefenseGAN and classifier holding the
    benchmark's weights, built from the configuration's program_config and
    program_overrides; enc_w: the encoder's weights under encoder init."""

    def __init__(self, conf: Dict, gen_w: Dict[str, torch.Tensor],
                 clf_w: Dict[str, torch.Tensor], device: torch.device,
                 recorder: Recorder,
                 enc_w: Optional[Dict[str, torch.Tensor]] = None):
        from defensegan_torch.ckpt.bridge import load_flax_tree
        from defensegan_torch.configs import load_config
        from defensegan_torch.defense.pipeline import DefendedPipeline
        from defensegan_torch.gan import DefenseGAN
        from defensegan_torch.models import build_classifier, encoder_for

        cfg = load_config(os.path.join(ROOT, conf["program_config"]),
                          conf["program_overrides"])
        gan = DefenseGAN(cfg, device=device)
        g, want = gan.generator, conf["generator"]
        got = dict(latent_dim=g.latent_dim, base_hw=g.base_hw,
                   channels=list(g.channels), out_channels=g.out_channels,
                   kernel=g.kernel, stride=2)
        if got != want:
            raise ValueError(f"the program built generator {got}, the "
                             f"configuration states {want}")
        load_flax_tree(g, *_nested(gen_w))
        enc = encoder_of(conf)
        if enc is not None:
            e = encoder_for(cfg.type, cfg.disc_dim, z_dim=cfg.latent_dim,
                            dtype=gan.dtype).to(device).requires_grad_(False)
            got = dict(channels=list(e.channels), kernel=e.conv_0.k,
                       z_dim=e.z_dim, in_channels=e.conv_0.weight.shape[1],
                       features=e.fc_z.weight.shape[1])
            want = dict(channels=list(enc.channels), kernel=enc.kernel,
                        z_dim=enc.z_dim, in_channels=enc.in_channels,
                        features=enc.features)
            if got != want:
                raise ValueError(f"the program built encoder {got}, the "
                                 f"configuration states {want}")
            load_flax_tree(e, _nested(enc_w)[0])
            gan.encoder = e
        gan.weights_changed()
        cl = conf["classifier"]
        clf = build_classifier(cl["model"], cl["num_classes"],
                               image_shape=tuple(conf["image_shape"]))
        clf = clf.to(device).requires_grad_(False)
        load_flax_tree(clf, _nested(clf_w)[0])
        gan.reconstruct = recorder.wrap(gan.reconstruct,
                                        lambda: str(gan.last_kernel))
        pl, pr = conf["pipeline"], conf["projection"]
        self.pipe = DefendedPipeline(
            gan, clf, fpr=pl["fpr"], detector=pl["detector"],
            rec_rr=pr["restarts"], rec_iters=pr["iters"], rec_lr=pr["lr"],
            rec_init=None if enc is None else "encoder")

    def calibrate(self, x, z0_fn) -> None:
        self.pipe.calibrate(x, z0_fn=z0_fn)

    def predict(self, x, z0_fn):
        return self.pipe.predict(x, z0_fn=z0_fn)
