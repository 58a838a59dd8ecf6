"""The slice as a whole against the JAX package: both run loops'
``Experiment.validate`` on one tiny DFaust recipe and fixture, with the
tiny FPNSegUNetMLPGeluRotEqFAUST of ``torch_port_helpers`` in both, the JAX
``init_state`` parameters (randomised so every layer shows), BN statistics
and calibration buffers (after the JAX ``calibrate``) carried across with
``utils.weights.from_flax``.  The JAX eval step draws its hierarchy from
``PRNGKey(batch index)``; the port's is given the same draws
(``jax_hierarchy_draws``), two frames per point.  Per-class IoU and mIoU
must agree; a prediction may differ only where the JAX logits of the two
classes lie within 2e-4, the repo's whole-model bound."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.train import Trainer as JTrainer
from se3conv3d_tpu.train.metrics import SemSegMetrics as JSemSegMetrics
from se3conv3d_tpu.train.run import Experiment as JExperiment

from se3conv3d_tpu_torch.models import FPNSegUNet
from se3conv3d_tpu_torch.train.run import Experiment
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

from torch_port_helpers import TINY, dfaust_recipe, jax_hierarchy_draws, randomize, write_dfaust

torch.set_num_threads(2)

BOUND = 2e-4


def tiny_recipe():
    recipe = dfaust_recipe()
    recipe["Dataset"]["num_points"] = 128
    recipe["Model"].update(init_subsample=0.08, output_subsample=0.1, grid_subsamples=[0.16, 0.32],
                           capacities=[128, 64, 32], out_capacity=128)
    recipe["Model"]["RefFrames"].update(train_n_frames=2, test_n_frames=2)
    return recipe


def test_validate_matches_the_jax_run_loop(tmp_path):
    root = write_dfaust(tmp_path / "data", n_train=4, n_test=3, n_pts=128, seed=5)
    conf = tmp_path / "recipe.yaml"
    conf.write_text(yaml.safe_dump(tiny_recipe()))

    jexp = JExperiment(str(conf), root, log_folder=str(tmp_path / "jlog"))
    spec = dataclasses.replace(jexp.model.spec, **TINY)
    jexp.model = JNet(spec, jexp.num_in_feats, jexp.num_classes)
    jexp.trainer = JTrainer(jexp.model, jexp.hcfg, jexp.trainer.tx, jexp.trainer.settings,
                            eval_hierarchy_config=jexp.eval_hcfg)
    state = jexp.init_state()
    rng = np.random.default_rng(6)
    state = state.replace(params=randomize(state.params, rng),
                          batch_stats=randomize(state.batch_stats, rng))
    state = jexp.calibrate(state)

    texp = Experiment(str(conf), root, log_folder=str(tmp_path / "tlog"), device="cpu")
    model = FPNSegUNet(dataclasses.replace(texp.model.spec, **TINY), texp.num_in_feats,
                       texp.num_classes)
    model.load_state_dict(from_flax(*jax.device_get((state.params, state.batch_stats, state.calib))))
    texp.model = model
    texp.trainer = Trainer(model, texp.hcfg, texp.eval_hcfg, **texp._trainer_kwargs)

    jlogits, tlogits = [], []
    jeval, teval = jexp.trainer.eval_step, texp.trainer.eval_step

    def jax_eval(st, batch, key):
        out = jeval(st, batch, key)
        jlogits.append((np.asarray(out["logits"]), np.asarray(out["mask"]), np.asarray(out["labels"])))
        return out

    def port_eval(batch, generator=None):
        bi = len(tlogits)
        b, n = batch["positions"].shape[:2]
        draws = jax_hierarchy_draws(jax.random.PRNGKey(bi), jexp.eval_hcfg, b, n)
        out = teval(batch, draws=draws)
        tlogits.append(out["logits"].numpy())
        return out

    jexp.trainer.eval_step = jax_eval
    texp.trainer.eval_step = port_eval
    want = jexp.validate(state)
    got = texp.validate()
    assert len(jlogits) == len(tlogits) == 2  # 3 test bodies: a batch of 2, then one of 1
    differ, preds = 0, []
    for (jl, mask, labels), tl in zip(jlogits, tlogits):
        assert tl.shape == jl.shape
        jp, tp = jl.argmax(-1), tl.argmax(-1)
        preds.append((tp, mask, labels))
        off = (jp != tp) & mask
        differ += int(off.sum())
        rows = np.nonzero(off)
        gap = np.abs(np.take_along_axis(jl, jp[..., None], -1)[..., 0]
                     - np.take_along_axis(jl, tp[..., None], -1)[..., 0])[rows]
        assert (gap <= BOUND).all(), gap.max()
        assert np.abs(tl - jl)[mask].max() <= BOUND * max(np.abs(jl[mask]).max(), 1.0)
    if differ:  # near-ties only: the port's IoU is the JAX metric of the port's predictions
        want = JSemSegMetrics.empty(jexp.num_classes)
        for tp, mask, labels in preds:
            want = want.update(jnp.asarray(tp), jnp.asarray(labels), jnp.asarray(mask))
        want = want.summary()
    np.testing.assert_allclose(got["iou_per_class"], want["iou_per_class"], rtol=0, atol=1e-12)
    for k in ("miou", "macc", "overall_acc"):
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0.0 < got["miou"] < 1.0
