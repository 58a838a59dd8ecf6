"""Boundaries of the PyTorch port: it runs without JAX, PyYAML, h5py or the
JAX package (its training and evaluation CLIs too), importing it touches no triton and no
CUDA, its native library builds only into its git-ignored directory, and
``chip_smoke.py`` refuses to report a result without a GPU."""
import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "se3conv3d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "h5py", "se3conv3d_tpu", "triton")
# modules the scan must reach (the last ones ported: data parallelism, the
# dense-voxel baseline, farthest-point sampling, the offline preprocessing)
MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py", "models/minkunet.py",
           "core/fps.py", "preprocess/__init__.py", "preprocess/amass.py", "preprocess/dfaust.py")


def test_port_sources_import_nothing_forbidden():
    pattern = re.compile(r"^\s*(?:import|from)\s+(\w+)", re.M)
    seen = set()
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    mods = set(pattern.findall(fh.read()))
                assert not mods & set(FORBIDDEN), (name, mods & set(FORBIDDEN))
                seen.add(os.path.relpath(os.path.join(root, name), PKG))
    assert not set(MODULES) - seen, set(MODULES) - seen


def test_cpu_slice_runs_with_jax_poisoned(tmp_path):
    import yaml
    from torch_port_helpers import dfaust_recipe, write_dfaust

    root = write_dfaust(tmp_path / "data", n_train=2, n_test=1)
    recipe = dfaust_recipe()
    recipe["Training"]["num_epochs"] = 1
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(recipe))
    argv = ["--conf_file", str(conf), "--data_folder", root, "--log_folder", str(tmp_path / "log")]
    test_argv = ["--conf_file", "configs/dfaust/dfaust_test.yaml"] + argv[2:]
    code = textwrap.dedent(f"""
        import sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        import dataclasses, pkgutil, importlib
        import torch
        torch.set_num_threads(2)
        import se3conv3d_tpu_torch
        for mod in pkgutil.walk_packages(se3conv3d_tpu_torch.__path__, "se3conv3d_tpu_torch."):
            importlib.import_module(mod.name)
        from se3conv3d_tpu_torch.core.hierarchy import FrameConfig, HierarchyConfig
        from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
        from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec
        from se3conv3d_tpu_torch.train.trainer import Trainer
        spec = dataclasses.replace(
            get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), patch_num_features=(8,),
            num_blocks=(1, 1), num_features=(8, 16), fpn_dec_feats=8, max_neighbors=8)
        cfg = HierarchyConfig(0.08, (0.16, 0.32), (128, 64, 32), 0.1, 128,
                              FrameConfig(n_frames=2, neigh_k=8))
        gen = torch.Generator().manual_seed(0)
        model = FPNSegUNet(spec, 1, 5, generator=gen)
        trainer = Trainer(model, cfg)
        batch = dict(positions=torch.rand(1, 150, 3, generator=gen),
                     mask=torch.ones(1, 150, dtype=torch.bool), features=torch.ones(1, 150, 1))
        trainer.calibration_step(batch, gen)
        out = trainer.eval_step(batch, gen)
        assert out["logits"].shape == (1, 128, 5) and torch.isfinite(out["logits"]).all()
        assert kfe.fused_equiv_fwd.launches == 0
        from se3conv3d_tpu_torch.tasks.train import main
        exp = main({argv!r}, device="cpu")
        assert exp.ckpt.all_steps() == [0] and exp.trainer.step == 1
        from se3conv3d_tpu_torch.tasks.test_seg import main as test_seg
        voter, summary = test_seg({test_argv!r}, device="cpu")
        assert 0.0 <= summary["miou"] <= 1.0 and voter.accum[0].shape == (96, 20)
        assert "triton" not in sys.modules or sys.modules["triton"] is None
        assert not torch.cuda.is_initialized()
        print("port-ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("port-ok")


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_native_build_writes_only_into_its_ignored_directory(tmp_path):
    """A fresh build (a copy of the port's native sources) writes the library
    under ``native/_build/`` and nothing else, and git ignores that place."""
    import shutil
    native = tmp_path / "se3conv3d_tpu_torch" / "native"
    shutil.copytree(os.path.join(PKG, "native"), native,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent("""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location("pcprep_native", sys.argv[1])
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.load_library() is not None
        print(mod.library_path())
    """)
    before = sorted(os.listdir(native))
    proc = subprocess.run([sys.executable, "-B", "-c", code, str(native / "__init__.py")],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    built = proc.stdout.strip().splitlines()[-1]
    assert os.path.dirname(built) == str(native / "_build")
    assert sorted(os.listdir(native)) == sorted(before + ["_build"])
    assert [p for p in os.listdir(native / "_build")] == [os.path.basename(built)]
    assert sorted(os.listdir(tmp_path)) == ["se3conv3d_tpu_torch"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "se3conv3d_tpu_torch/native/_build/" in f.read().split()
