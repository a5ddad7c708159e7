"""The PyTorch port's boundaries: the committed weight export, the layout
bridge, the config copy, device selection, and the rule that the port
imports nothing of JAX or of the JAX package."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from defensegan_tpu.configs import load_config as jax_load_config
from defensegan_torch.ckpt.bridge import (conv_transpose_weight,
                                          conv_weight, dense_weight,
                                          export_path, load_flax_tree,
                                          read_export, unflatten)
from defensegan_torch.configs import Config, load_config, save_config
from defensegan_torch.gan import DefenseGAN
from defensegan_torch.models.generator import generator_for

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUN = ROOT / "output" / "gans" / "mnist_fast"


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_export_equals_orbax_checkpoint():
    """Re-export the flagship from its orbax checkpoints (JAX, CPU): the
    committed npz must hold exactly those arrays."""
    export = _load_script("export_torch_weights")
    arrays, manifest = export.export_arrays(str(RUN))
    path = export_path(str(RUN))
    assert path.endswith(os.path.join("export", "20000.npz"))
    with np.load(path) as z:
        assert sorted(z.files) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    tree = read_export(path)
    assert tree["manifest"]["step"] == manifest["step"] == 20000
    assert tree["generator"]["params"]["fc_in"]["kernel"].shape == \
        (128, 6272)
    assert set(tree["encoder"]["params"]) == {"conv_0", "conv_1", "fc_z"}


def _port_sources():
    """Every file of the port, by pattern: the package, the smoke, the
    root entry points (*_torch.py), the scripts (*_torch.py, torch_*.py;
    the JAX-side exporter export_torch_weights.py matches neither), and
    the module the ranks of the CPU tests import."""
    files = set((ROOT / "defensegan_torch").rglob("*.py"))
    files |= set(ROOT.glob("*_torch.py"))
    files |= set((ROOT / "scripts").glob("*_torch.py"))
    files |= set((ROOT / "scripts").glob("torch_*.py"))
    files |= {ROOT / "chip_smoke.py",
              ROOT / "tests" / "torch_parallel_workers.py"}
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "defensegan_tpu"), f"{path}: imports {n}"


def test_port_imports_cleanly_without_jax_loaded():
    """Importing every module of the port (as the CPU tests do) pulls in
    no JAX and needs no nvcc."""
    code = ("import importlib, pkgutil, sys, defensegan_torch\n"
            "for m in pkgutil.walk_packages(defensegan_torch.__path__, "
            "'defensegan_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'defensegan_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_default_device_is_cuda_or_raises():
    cfg = Config(type="mnist", gen_arch="wide", gen_dim=2, latent_dim=8)
    if torch.cuda.is_available():
        assert DefenseGAN(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DefenseGAN(cfg)
    assert DefenseGAN(cfg, device="cpu").device.type == "cpu"


def test_flagship_loads_through_the_entry_point():
    cfg = load_config(str(RUN)).replace(output_dir=str(RUN))
    gan = DefenseGAN(cfg, device="cpu").load()
    assert gan.step == 20000 and gan.has_encoder()
    tree = read_export(export_path(str(RUN)))
    np.testing.assert_array_equal(
        gan.generator.fc_in.weight.numpy(),
        tree["generator"]["params"]["fc_in"]["kernel"].T)
    z = gan.encode(torch.zeros(2, 28, 28, 1))
    assert z.shape == (2, 128) and torch.isfinite(z).all()


def test_64x64_run_exports_and_loads(tmp_path):
    """The export script on a run of a 64x64 config, as on the day a
    trained checkpoint exists: a (narrow, untrained) JAX CelebA model saves
    a checkpoint, `export_torch_weights.py --run <dir>` writes the numpy
    export, and the port's DefenseGAN loads it through its entry point and
    generates the same images (float32: 1e-5, summation order)."""
    import jax
    import jax.numpy as jnp
    from defensegan_tpu.configs import Config as JaxConfig
    from defensegan_tpu.gan import DefenseGAN as JaxGAN
    run = str(tmp_path / "celeba")
    jgan = JaxGAN(JaxConfig(type="celeba", gen_arch="deep", gen_dim=4,
                            disc_dim=4, latent_dim=16, image_size=64,
                            channels=3, compute_dtype="float32",
                            output_dir=run))
    rng = np.random.RandomState(0)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.5 * rng.rand(
        *a.shape).astype(np.float32), jgan.state.gen_stats)
    jgan.state = jgan.state.replace(gen_stats=stats)
    jgan.save()
    _load_script("export_torch_weights").main(["--run", run])
    step = int(jgan.state.step)
    assert export_path(run).endswith(os.path.join("export", f"{step}.npz"))
    gan = DefenseGAN(load_config(run).replace(output_dir=run),
                     device="cpu").load()
    assert gan.step == step and not gan.has_encoder()
    assert gan.generator.channels == (32, 16, 8, 4)
    z = rng.randn(3, 16).astype(np.float32)
    ref = np.asarray(jgan.gen_apply_tanh(jnp.asarray(z)))
    with torch.no_grad():
        got = gan.gen_apply_tanh(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_layout_maps():
    k = np.arange(5 * 5 * 3 * 2, dtype=np.float32).reshape(5, 5, 3, 2)
    np.testing.assert_array_equal(conv_weight(k)[1, 2, 3, 4], k[3, 4, 2, 1])
    np.testing.assert_array_equal(conv_transpose_weight(k)[2, 1, 0, 3],
                                  k[4, 1, 2, 1])
    d = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(dense_weight(d), d.T)
    assert unflatten({"a/b/c": 1, "a/d": 2}) == {"a": {"b": {"c": 1},
                                                      "d": 2}}


def test_bridge_rejects_mismatched_trees():
    g = generator_for("mnist", 2, arch="wide", latent_dim=8)
    tree = read_export(export_path(str(RUN)))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flax_tree(g, tree["generator"]["params"],
                       tree["generator"]["batch_stats"])
    with pytest.raises(KeyError):
        load_flax_tree(g, {"fc_in": {}})


@pytest.mark.parametrize("name", ["mnist_fast", "mnist", "celeba",
                                  "celeba_wide", "imagenet64", "digits",
                                  "fmnist", "fmnist_fast"])
def test_config_copy_reads_yaml_like_jax(name, tmp_path):
    path = ROOT / "defensegan_torch" / "configs" / "gans" / f"{name}.yml"
    jax_path = ROOT / "defensegan_tpu" / "configs" / "gans" / f"{name}.yml"
    assert path.read_text() == jax_path.read_text()
    cfg = load_config(str(path))
    ref = jax_load_config(str(path))
    assert cfg.to_yaml_dict() == ref.to_yaml_dict()
    assert cfg.image_shape == ref.image_shape
    cfg = cfg.replace(output_dir=str(tmp_path))
    save_config(cfg)
    assert load_config(str(tmp_path)) == cfg
    with pytest.raises(ValueError):
        load_config(str(path), {"NOT_A_KEY": 1})
