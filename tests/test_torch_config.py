"""The port's config reader (``climsim_tpu_torch/train/config.py``)
against PyYAML and the JAX package's ``load_config``: every ``conf/*.yaml``
reads as ``yaml.safe_load`` reads it, except where YAML 1.1 (PyYAML) and
YAML 1.2 (the port) resolve a scalar differently; overrides parse as
JAX's ``_parse_value``; anything outside the subset raises with its line;
``save_config`` round-trips. The port's training CLI imports without
PyYAML and h5py."""
import glob
import os
import subprocess
import sys

import pytest
import yaml

from climsim_tpu.train import config as JC
from climsim_tpu_torch.train import config as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "*.yaml")))
# the keys YAML 1.1 and 1.2 read differently: an exponent without a sign
# is a string to PyYAML, a float to YAML 1.2
YAML_11_VS_12 = {"autoreg_physrnn.yaml": {("loss", "w_wcon"): 3.0e7},
                 "autoreg_longwindows.yaml": {("loss", "w_wcon"): 3.0e7}}


def _get(d, path):
    for k in path:
        d = d[k]
    return d


def test_every_conf_is_covered():
    assert len(CONFS) >= 7
    assert set(YAML_11_VS_12) <= {os.path.basename(p) for p in CONFS}


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_reader_equals_pyyaml(path):
    """Equal values and types (an int stays an int, 1.0e-3 a float, the
    flow mapping's keys ints), key order included; the listed keys are
    PyYAML's string and the port's float."""
    text = open(path).read()
    want = yaml.safe_load(text)
    got = TC.parse_yaml(text)
    diffs = YAML_11_VS_12.get(os.path.basename(path), {})
    for keypath, value in diffs.items():
        assert _get(want, keypath) == "3.0e7"
        assert _get(got, keypath) == value and \
            type(_get(got, keypath)) is float
        parent = _get(want, keypath[:-1])
        parent[keypath[-1]] = value
    assert got == want

    def types(d):
        return {k: types(v) if isinstance(v, dict) else
                (type(v), [type(x) for x in v] if isinstance(v, list)
                 else None) for k, v in d.items()}
    assert types(got) == types(want)
    assert list(got) == list(want)


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    """load_config with overrides equals JAX's up to the listed keys."""
    overrides = ["optimizer.lr=3e-4", "model.nneur=[16,16]",
                 "rollout.schedule={0: 2}", "platform=cpu", "resume=true",
                 "data.norm=null", "new.deep.key=abc"]
    want = JC.load_config(path, overrides).to_dict()
    got = TC.load_config(path, overrides)
    for keypath, value in YAML_11_VS_12.get(os.path.basename(path),
                                            {}).items():
        _get(want, keypath[:-1])[keypath[-1]] = value
    assert got.to_dict() == want
    assert got.optimizer.lr == 3e-4 and got.new.deep.key == "abc"


@pytest.mark.parametrize("text,value", [
    ("1", 1), ("-7", -7), ("+3", 3), ("0o17", 15), ("0x1F", 31),
    ("1.5", 1.5), ("3.0e7", 3.0e7), ("5.0e-6", 5.0e-6), ("1e3", 1000.0),
    (".5", 0.5), ("-.inf", float("-inf")), ("true", True), ("False", False),
    ("null", None), ("~", None), ("abc", "abc"), ("v4_rnn", "v4_rnn"),
    ("/a/b.nc", "/a/b.nc"), ("1.2.3", "1.2.3"), ("yes", "yes"),
    ("on", "on")])
def test_core_schema_scalars(text, value):
    """YAML 1.2 core schema: exponents without sign are floats, and yes/on
    (1.1 booleans) are strings."""
    got = TC.parse_yaml(f"k: {text}\n")["k"]
    assert got == value and type(got) is type(value)


def test_nan_scalar():
    v = TC.parse_yaml("k: .nan\n")["k"]
    assert v != v


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: 'quoted'\n", 2), ("a:\n  - 1\n", 2), ("a: &x 1\n", 1),
    ("a: !!str 1\n", 1), ("---\na: 1\n", 1), ("a: |\n  text\n", 1),
    ("a: 1\n\tb: 2\n", 2), ("a: 1\na: 2\n", 2), ("a: [1, [2]]\n", 1),
    ("a: {0: 1\n", 1), ("a:\n  b: 1\n c: 2\n", 3), ("just a line\n", 1),
    ("a: {0: 1, 0: 2}\n", 1)])
def test_outside_subset_raises_with_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        TC.parse_yaml(text)


def test_comments_and_nesting():
    text = ("# head\nmodel:   # trailing\n  nneur: [1, 2]  # c\n"
            "  # indented full-line comment\n  deep:\n    x: a#b\n"
            "opt:\nempty: {}\nlist: []\n")
    assert TC.parse_yaml(text) == {
        "model": {"nneur": [1, 2], "deep": {"x": "a#b"}}, "opt": None,
        "empty": {}, "list": []}
    assert TC.parse_yaml("") == {} and TC.parse_yaml("# only\n") == {}


@pytest.mark.parametrize("s", ["true", "False", "None", "null", "3e-4",
                               "[1, 2]", "{0: 1, 3: 2}", "cpu", "1.0e-3",
                               "(9, 14)", "'quoted'"])
def test_overrides_parse_as_jax(s):
    assert TC._parse_value(s) == JC._parse_value(s)


def test_save_config_round_trips(tmp_path):
    cfg = TC.load_config(os.path.join(REPO, "conf", "autoreg_physrnn.yaml"),
                         ["model.nneur=[16,16]", "x.y=-1.5e-07",
                          "z=1e300", "n=null", "s=[1, 2.5]"])
    path = str(tmp_path / "c.yaml")
    TC.save_config(cfg, path)
    assert TC.load_config(path).to_dict() == cfg.to_dict()
    # PyYAML reads the written file the same way: its floats carry
    # a dot and a signed exponent
    assert yaml.safe_load(open(path)) == cfg.to_dict()
    with pytest.raises(ValueError, match="plain scalar"):
        TC.save_config(TC.Config({"a": "true"}), path)


def test_cli_imports_without_pyyaml_and_h5py():
    """With yaml and h5py unimportable, the training CLI imports and reads
    a yaml."""
    code = ("import sys; sys.modules['yaml'] = None; "
            "sys.modules['h5py'] = None; "
            "import climsim_tpu_torch.cli.train_rollout as m; "
            "from climsim_tpu_torch.train.config import load_config; "
            "c = load_config('conf/autoreg_physrnn.yaml'); "
            "assert c.loss.w_wcon == 3e7; "
            "assert 'yaml' not in [k for k, v in sys.modules.items() "
            "if v is not None]; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
