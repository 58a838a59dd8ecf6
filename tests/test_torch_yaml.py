"""The port's recipe reader (``se3conv3d_tpu_torch/utils/yaml_subset.py``)
against PyYAML on every recipe under ``configs/``, its writer read back by
both, the pinned recipes of ``models/presets.py`` against their files, and
the two ScanNet SO2 rot recipes built from their files."""
import dataclasses
import glob
import os

import pytest
import torch
import yaml

from se3conv3d_tpu.train import config as jconfig

from se3conv3d_tpu_torch.models import presets
from se3conv3d_tpu_torch.train import config as tconfig
from se3conv3d_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                                             recursive=True))


def test_every_recipe_is_collected():
    assert len(RECIPES) == 26  # 14 training recipes and 12 test regimes


@pytest.mark.parametrize("path", RECIPES)
def test_reader_equals_pyyaml_and_writer_reads_back(path, tmp_path):
    with open(os.path.join(REPO, path)) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load(os.path.join(REPO, path))
    assert got == want
    assert [type(v) for v in _leaves(got)] == [type(v) for v in _leaves(want)]
    out = tmp_path / "config.yaml"
    cfg = tconfig.load_yaml_config(os.path.join(REPO, path))
    tconfig.dump_yaml_config(cfg, str(out))
    assert tconfig.load_yaml_config(str(out)) == cfg
    assert yaml.safe_load(out.read_text()) == cfg


def _leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("text", [
    "a: 0.0001", "a: 100.0", "a: 1e-4", "a: 1.0e-4", "a: -.inf", "a: .nan", "a: 0x1F", "a: 017",
    "a: 0b101", "a: 1_000", "a: yes", "a: Off", "a: ~", "a:", "a: None", "a: null",
    "a: 'it''s # not a comment'", "a: b  # trailing", "a: [1, 'x y', [2.5, true]]", "a: {}",
    "a: []", "m:\n    4: 0.15\n    2: 0.35", "a:\n- 1\n- 2\nb: 3", "a:\n  b:\n    - 0.1\n  c: x",
])
def test_scalars_resolve_as_pyyaml_resolves_them(text):
    got, want = yaml_subset.loads(text), yaml.safe_load(text)
    assert repr(got) == repr(want)  # repr: nan == nan, and 1 != True


@pytest.mark.parametrize("text, line", [
    ("a: &anchor 1", 1), ("a: 1\nb: *alias", 2), ("a: |\n  text", 1), ('a: "quoted"', 1),
    ("a:\n\tb: 1", 2), ("a: {b: 1}", 1), ("a:\n  - b: 1", 2), ("a: [1,\n  2]", 1),
    ("a: !!str 1", 1), ("a: 1:30", 1), ("a: 1\n  b: 2", 2), ("---\na: 1", 1),
])
def test_reader_raises_on_the_rest_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        yaml_subset.loads(text)


def test_writer_quotes_what_would_resolve_otherwise():
    cfg = {"s": "None", "t": "true", "n": "1e-4", "f": 1e-05, "g": 2.0, "i": 3, "on": 1,
           "b": False, "z": None, "l": [0.1, "x"], 4: 0.15, "e": {}}
    text = yaml_subset.dumps(cfg)
    assert yaml_subset.loads(text) == cfg == yaml.safe_load(text)


# every pinned recipe of models/presets.py: (prefix, file)
PINNED = {
    "DFAUST_I_ROT_PCA_2F": "dfaust/dfaust_I_rot_pca_2F.yaml",
    "DFAUST_I_ROT_PCA_MIXF": "dfaust/dfaust_I_rot_pca_mixF.yaml",
    "DFAUST_I_ROT_MC_2F": "dfaust/dfaust_I_rot_MC_2F.yaml",
    "DFAUST_I_ROT_MC_MIXF": "dfaust/dfaust_I_rot_MC_mixF.yaml",
    "DFAUST_I_STANDARD": "dfaust/dfaust_I_standard.yaml",
    "SCANNET20_ROT_PCA_I": "scannet/scannet20_rot_pca_I.yaml",
    "SCANNET20_ROT_I": "scannet/scannet20_rot_I.yaml",
    "SCANNET20_STANDARD_I": "scannet/scannet20_standard_I.yaml",
    "SCANNET20_STANDARD_SO2": "scannet/scannet20_standard_SO2.yaml",
    "MODELNET40_PCA_2F": "modelnet40/modelnet40_pca_2F.yaml",
    "MODELNET40_MC_2F": "modelnet40/modelnet40_MC_2F.yaml",
    "MODELNET40_STANDARD": "modelnet40/modelnet40_standard.yaml",
}


def test_every_pinned_recipe_is_listed():
    pinned = {n[: -len("_MODEL")] for n in presets.__all__ if n.endswith("_MODEL")}
    assert pinned == set(PINNED)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_recipe_equals_its_file_through_the_reader(name):
    cfg = tconfig.load_yaml_config(os.path.join(REPO, "configs", PINNED[name]))
    assert getattr(presets, f"{name}_MODEL") == cfg["Model"]
    assert getattr(presets, f"{name}_TRAINING") == cfg["Training"]


@pytest.mark.parametrize("recipe", ["scannet20_rot_SO2", "scannet20_rot_pca_SO2"])
def test_scannet_so2_rot_recipe_builds_from_its_file(recipe):
    path = os.path.join(REPO, "configs", "scannet", f"{recipe}.yaml")
    cfg = tconfig.load_yaml_config(path)
    assert cfg == jconfig.load_yaml_config(path)
    md = cfg["Model"]
    assert md["RefFrames"]["fixed_axis"] == 2
    for train in (True, False):
        want = dataclasses.asdict(jconfig.frame_config_from_dict(md["RefFrames"], train))
        got = dataclasses.asdict(presets.frame_config_from_dict(md["RefFrames"], train))
        assert {k: got[k] for k in want} == want
        assert set(got) - set(want) <= {"global_frames"} and not got.get("global_frames")
    hcfg = presets.hierarchy_config_from_model_dict(md, 131072, train=True)
    jh = jconfig.hierarchy_config_from_model_dict(md, 131072, train=True)
    assert (hcfg.init_cell_size, hcfg.cell_sizes, hcfg.capacities, hcfg.out_cell_size,
            hcfg.out_capacity) == (jh.init_cell_size, jh.cell_sizes, jh.capacities,
                                   jh.out_cell_size, jh.out_capacity)
    model = tconfig.build_model_from_config(md, 6, 21, device="cpu",
                                            generator=torch.Generator().manual_seed(0))
    convs = [m for m in model.modules() if type(m).__name__ == "PNEConv"]
    assert len(convs) == 32 and all(c.equivariant and c.compute_dtype == torch.bfloat16 for c in convs)


def test_augmentation_modules_load_by_dotted_path():
    assert tconfig.load_augmentations("None") == [] == tconfig.load_augmentations(None)
    augs = tconfig.load_augmentations("configs.scannet.ScanNet_DS_Aug")
    assert [a["name"] for a in augs] == [a["name"] for a in
                                          jconfig.load_augmentations("configs.scannet.ScanNet_DS_Aug")]
