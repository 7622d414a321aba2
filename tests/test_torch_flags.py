"""The port's flags and opts.yaml (``magicmirror_torch/configs/flags.py``)
against the JAX package's (``magicmirror/configs/flags.py``), and
``train.train_options``: the parsed flags as ``TrainOptions``.

The port's opts.yaml must be ``yaml.safe_load``-equal to the JAX package's
for the same options, and each package must read the other's file.
"""
import pytest
import yaml

from magicmirror.configs import flags as jflags
from magicmirror_torch.configs import flags
from magicmirror_torch.train import TrainOptions, train_options

ARGVS = (
    [],
    ["--name", "yes", "--dataroot", "/data/CUB 2011", "--lr", "1e-5", "--gamma", "0.001",
     "--elev_range=-15~15", "--dist_range", "2~6", "--threshold", "0.1,0.9",
     "--ratio", "2", "--niter", "3", "--clean", "0.2,0.5", "--swa_lr", "inf",
     "--soft_mode", "exact", "--steps_per_call", "1", "--resume"],
)


def test_every_flag_and_default_is_the_jax_packages():
    ours, ref = flags.build_parser(), jflags.build_parser()
    assert vars(ours.parse_args([])) == vars(ref.parse_args([]))
    for argv in ARGVS:  # prefix matches included (--clean)
        assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))
    key = lambda a: a.dest  # noqa: E731
    for a, r in zip(sorted(ours._actions, key=key), sorted(ref._actions, key=key)):
        assert (a.dest, a.option_strings, a.default, a.type, a.choices, a.nargs) == (
            r.dest, r.option_strings, r.default, r.type, r.choices, r.nargs)


@pytest.mark.parametrize("argv", ARGVS)
def test_opts_yaml_is_the_jax_packages(tmp_path, monkeypatch, argv):
    """finalize_options and save_options in both packages: the two files
    load equal with yaml.safe_load; each package reads the other's file back
    to the options it was written from."""
    monkeypatch.chdir(tmp_path)
    ours = flags.finalize_options(flags.build_parser().parse_args(argv))
    ref = jflags.finalize_options(jflags.build_parser().parse_args(argv))
    assert vars(ours) == vars(ref)
    flags.save_options(ours, "ours/opts.yaml")
    jflags.save_options(ref, "ref/opts.yaml")
    with open("ours/opts.yaml") as a, open("ref/opts.yaml") as r:
        loaded, loaded_ref = yaml.safe_load(a), yaml.safe_load(r)
    assert loaded == loaded_ref == vars(ours)

    blank = flags.build_parser().parse_args(["--name", "other"])
    back = flags.load_options(blank, "ref/opts.yaml", skip=())
    assert vars(back) == vars(ref)
    kept = flags.load_options(flags.build_parser().parse_args(["--name", "other"]),
                              "ref/opts.yaml")
    assert (kept.name, kept.lr, kept.resume, hasattr(kept, "outf")) == ("other", ref.lr, False,
                                                                        False)
    jback = jflags.load_options(jflags.build_parser().parse_args(["--name", "other"]),
                                "ours/opts.yaml", skip=())
    assert vars(jback) == vars(ours)


def test_train_options_from_the_parsed_flags():
    """The fields of TrainOptions come from the flags; the CLI's and the
    ignored TPU flags are left out; an unported flag at another value than
    its default raises, at its default it does not; the encoder, critic and
    loss options are taken."""
    opt = train_options(flags.build_parser().parse_args(
        ["--lr", "3e-4", "--niter", "7", "--steps_per_call", "1", "--donate_state",
         "--band_capacity", "320", "--raster_backend", "xla", "--hard_range", "30"]))
    assert isinstance(opt, TrainOptions)
    assert (opt.lr, opt.niter, opt.imageSize, opt.template_path, opt.hard_range) == (
        3e-4, 7, 128, "./template/sphere.obj", 30)
    for argv in (["--multigpus"], ["--fp16"], ["--pretrainc", "res18"],
                 ["--pretrains", "res50"], ["--pretraint", "swin"]):
        with pytest.raises(NotImplementedError):
            train_options(flags.build_parser().parse_args(argv))
    lifted = train_options(flags.build_parser().parse_args(
        ["--makeup", "1", "--gan_type", "lsgan", "--norm", "in", "--inv", "1",
         "--lambda_lc", "1", "--hmr", "1", "--dis1", "0.5"]))
    assert (lifted.makeup, lifted.gan_type, lifted.norm, lifted.inv, lifted.lambda_lc,
            lifted.hmr, lifted.dis1) == (1, "lsgan", "in", 1.0, 1.0, 1.0, 0.5)
    ns = flags.build_parser().parse_args([])
    ns.something_new = 1
    with pytest.raises(ValueError, match="something_new"):
        train_options(ns)
