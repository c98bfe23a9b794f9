"""The port's config tree (sos_wsod_torch/config.py) against the JAX
package's (sos_wsod_tpu/config/defaults.py):

  - the flat trees are equal key for key, value for value and type for
    type, except MODEL.DEVICE (a torch device) and the four TPU-only knobs
    (TPU.SCAN_STEPS, POOL_IMPL, POOL_ROW_CHUNKS, PRNG_IMPL), which the port
    leaves out;
  - an override or a YAML file that names one of those knobs raises, with a
    message naming it;
  - every command line of run/code_release/*.sh that takes a config merges
    in both packages to the same values: through the port's
    ``config_device`` and the setup of the port's CLI that the line runs,
    against the JAX ``get_cfg()`` merged with the same file and overrides.
"""
from __future__ import annotations

import pathlib
import re
import shlex

import pytest

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_torch.config import TPU_ONLY_KEYS, get_cfg
from sos_wsod_torch.engine.defaults import config_device, default_argument_parser
from sos_wsod_torch.tools import train_net_stage1, train_net_test_tta, train_net_unbias

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLIS = {"train_net_stage1": train_net_stage1, "train_net_unbias": train_net_unbias,
        "train_net_test_tta": train_net_test_tta}
LAUNCH_FLAGS = {"--num-gpus": 1, "--num-machines": 1, "--machine-rank": 1, "--dist-url": 1}


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _release_lines():
    """(script name, CLI name, argv without the launch flags) of every
    command line in run/code_release/*.sh that runs a port CLI with a
    literal config file."""
    out = []
    for path in sorted((ROOT / "run" / "code_release").glob("*.sh")):
        text = re.sub(r"\\\n", " ", path.read_text())
        for line in text.splitlines():
            m = re.match(r"\s*python3? tools/(\w+)\.py (.*)", line)
            if not m or m.group(1) not in CLIS or "$cfg" in line:
                continue
            words, argv = shlex.split(m.group(2)), []
            while words:
                w = words.pop(0)
                if w in LAUNCH_FLAGS:
                    words.pop(0)
                else:
                    argv.append(w)
            out.append((path.name, m.group(1), argv))
    return out


def test_the_trees_are_equal_but_the_device_and_the_tpu_only_knobs():
    ours, theirs = _flat(get_cfg().to_dict()), _flat(jax_get_cfg())
    assert set(theirs) - set(ours) == set(TPU_ONLY_KEYS)
    assert set(ours) <= set(theirs)
    differ = {k for k in ours if ours[k] != theirs[k] or type(ours[k]) is not type(theirs[k])}
    assert differ == {"MODEL.DEVICE"}, {k: (ours[k], theirs[k]) for k in differ}
    assert (ours["MODEL.DEVICE"], theirs["MODEL.DEVICE"]) == ("cuda", "tpu")


@pytest.mark.parametrize("key", TPU_ONLY_KEYS)
def test_a_tpu_only_knob_raises_naming_itself(key, tmp_path):
    cfg = get_cfg()
    with pytest.raises(KeyError, match=re.escape(key) + ".*TPU-only"):
        cfg.merge_from_list([key, "1"])
    section, leaf = key.split(".")
    path = tmp_path / "knob.yaml"
    path.write_text(f"_BASE_: {ROOT / 'configs' / 'stage1' / 'voc07_oicr_plus.yaml'}\n"
                    f"{section}:\n  {leaf}: 1\n")
    with pytest.raises(KeyError, match=re.escape(key)):
        get_cfg().merge_from_file(str(path))


def test_the_release_command_lines_merge_alike_in_both_packages(tmp_path, monkeypatch):
    lines = _release_lines()
    assert {name for name, _, _ in lines} >= {"voc_baseline.sh", "voc_ssod.sh",
                                              "coco_baseline.sh", "coco_ssod.sh",
                                              "oicr_plus_voc07.sh", "tta_test.sh"}
    monkeypatch.chdir(tmp_path)
    for name, cli, argv in lines:
        args = default_argument_parser().parse_args(
            [str(ROOT / a) if a.startswith("configs/") else a for a in argv])
        assert config_device(args.config_file, args.opts) == "cuda", name
        ours = _flat(CLIS[cli].setup(args).to_dict())
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(args.config_file)
        jcfg.merge_from_list(list(args.opts))
        theirs = _flat(jcfg)
        assert set(theirs) - set(ours) == set(TPU_ONLY_KEYS), name
        differ = {k for k in ours if ours[k] != theirs[k]}
        assert differ == {"MODEL.DEVICE"}, (name, {k: (ours[k], theirs[k]) for k in differ})
        if "TEST.VAL_LOSS" in args.opts:
            assert ours["TEST.VAL_LOSS"] is False, name
