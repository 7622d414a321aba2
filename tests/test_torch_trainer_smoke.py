"""CPU smoke of the port's trainer: the default model (HRNet-w18-small-v2 /
ResNet-34 / Base4C with CoordConv, 32^2, B = 2), two steps with dropout on,
finite metrics, every encoder moved; and the tiny model's dropout following
the trainer's generator.

Slow, and two test functions on purpose: under ``pytest -n 6 --dist loadfile``
the files with the most tests are handed out first, so a slow file with few
tests runs beside the suite's long files and not ahead of them.
"""
import numpy as np
import torch

from magicmirror_torch.train import METRIC_KEYS, TrainOptions, build_trainer
from test_torch_trainer import B, S, _photos, _tiny
from torch_parity import SPHERE

torch.set_num_threads(1)


def test_dropout_draws_from_the_trainers_generator():
    runs = []
    for seed in (0, 0, 1):
        trainer = build_trainer(_tiny(manualSeed=0), device="cpu")
        trainer.generator.manual_seed(seed)
        runs.append(float(trainer.step(_photos(), 1e-4, 1e-4)[0]["lossR"]))
    assert runs[0] == runs[1] != runs[2]


def test_default_model_trains_on_the_cpu():
    """hr18sv2 / res34 / Base4C with CoordConv, dropout 0.2: 56,147,800
    encoder parameters, as PERF.md counts them."""
    opt = TrainOptions(template_path=SPHERE, imageSize=S, batchSize=B)
    trainer = build_trainer(opt, device="cpu")
    assert sum(p.numel() for p in trainer.state.netE.parameters()) == 56_147_800
    before = {k: v.clone() for k, v in trainer.state.netE.state_dict().items()}
    for i in range(2):
        metrics, Xer, Xir = trainer.step(_photos(), 3e-4, 3e-4, warm_up=min(1.0, 0.01 + i / 20))
        assert all(np.isfinite(float(metrics[k])) for k in METRIC_KEYS), metrics
        assert float(metrics["skipE"]) == float(metrics["skipD"]) == 0.0
        assert Xer.shape == Xir.shape == (B, S, S, 4) and torch.isfinite(Xer).all()
    now = trainer.state.netE.state_dict()
    moved = [k for k in now if not torch.equal(now[k], before[k])]
    assert {k.split(".")[0] for k in moved} == {"shape_enc", "camera_enc", "texture_enc",
                                                "light_enc"}
