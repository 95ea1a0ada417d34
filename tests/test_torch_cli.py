"""The port's command line (``configs/cli.py``) against the JAX package's:
the argv cases of tests/test_cli.py parse to the same config on both sides
(compared as ``config_to_dict``'s nested dicts, exactly), the presets'
dataclasses carry the same fields and defaults, and bad arguments raise
the same errors."""
import pytest

from nrhints_torch.configs import cli as tcli
from nrhints_torch.configs import config as tconf
from nrhints_tpu.configs import cli as jcli
from nrhints_tpu.configs import config as jconf

ARGVS = {
    "default": [],
    "nr-hints": ["config:nr-hints"],
    "bare-preset": ["nr-hints"],
    "pl-naive": ["config:pl-naive"],
    "scalars": ["config:nr-hints", "--config.model.lr", "1e-3", "--config.model.batch_size", "128",
                "--config.data.path", "/data/x", "--config.seed", "1"],
    "dashes": ["config:nr-hints-cam-opt", "--config.data.view-num-limit", "1000", "--config.data.white-background",
               "False", "--config.model.geometry-warmup-end", "100000", "--config.model.sdf-network.init-bias", "0.05",
               "--config.data.is-z-up", "True"],
    "equals-deep": ["--config.model.renderer.n_samples=32"],
    "literal": ["--config.ray_generator.cam_opt_mode", "SE3"],
    "tuple": ["--config.model.renderer.specular_roughness", "0.1,0.2"],
    "optional": ["--config.ckpt_path", "/ck"],
    "optional-none": ["--config.ckpt_path", "None"],
    "enum": ["--config.data.pixel-sampling-strategy", "same_image"],
    "parallel": ["config:nr-hints", "--config.parallel.scale-global-batch", "True",
                 "--config.parallel.batch-scale-lr-rule", "sqrt", "--config.parallel.steps-per-dispatch", "8"],
}


def _both(argv):
    return (tcli.parse_cli(tconf.PRESETS, tconf.DEFAULT_PRESET, list(argv)),
            jcli.parse_cli(jconf.PRESETS, jconf.DEFAULT_PRESET, list(argv)))


@pytest.mark.parametrize("argv", ARGVS.values(), ids=ARGVS.keys())
def test_parse_cli_matches_jax(argv):
    t, j = _both(argv)
    assert tcli.config_to_dict(t) == jcli.config_to_dict(j)


def test_presets_and_defaults_match_jax():
    """The same preset names and default preset, and every field of every
    preset with JAX's default value."""
    assert list(tconf.PRESETS) == list(jconf.PRESETS) and tconf.DEFAULT_PRESET == jconf.DEFAULT_PRESET
    for name in tconf.PRESETS:
        assert tcli.config_to_dict(tconf.PRESETS[name]()) == jcli.config_to_dict(jconf.PRESETS[name]()), name
    assert tcli._leaf_paths(tconf.SystemConfig()).keys() == jcli._leaf_paths(jconf.SystemConfig()).keys()


@pytest.mark.parametrize("argv,error", [
    (["config:nope"], SystemExit),
    (["--config.data.white_background", "maybe"], ValueError),
    (["--config.ray_generator.cam_opt_mode", "SE9"], ValueError),
    (["--config.model.no_such_field", "3"], KeyError),
    (["--config.seed"], SystemExit),
    (["--seed", "3"], SystemExit),
], ids=["preset", "bool", "literal", "field", "no-value", "not-a-config-flag"])
def test_bad_arguments_raise_as_jax(argv, error):
    for parse in (tcli.parse_cli, jcli.parse_cli):
        presets = tconf if parse is tcli.parse_cli else jconf
        with pytest.raises(error):
            parse(presets.PRESETS, presets.DEFAULT_PRESET, argv)


def test_help_lists_presets_and_flags(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.parse_cli(tconf.PRESETS, tconf.DEFAULT_PRESET, ["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "python -m nrhints_torch" in out and "config:nr-hints-cam-opt (default)" in out
    assert "--config.model.sdf_network.d_hidden = 256" in out
