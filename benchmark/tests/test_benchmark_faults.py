"""``correct`` comes out false for the control and for each fault a cell can
have: the rest of a run is driven with the timed path broken underneath, at
tiny sizes on the CPU; and on the card, the control at the cells' own sizes."""

import pytest
import torch

from bench_tiny import tiny_job
from harness import manifest, runner
from harness.compare import judge
from harness.job import Job
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import DeviceMovingMNIST
from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

CELLS = ["mnist_dcgan.train_f32", "sst.train_f32", "mnist_dcgan.serve_f32"]
GENERATORS = {"mnist_dcgan.train_f32": DeviceMovingMNIST, "sst.train_f32": DeviceZoneWindows}


def _still(monkeypatch, name):
    """The step returns its state unchanged: Adam applies nothing."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half(monkeypatch, name):
    """Half of the batch left out, the mean taken over the rest."""
    cls = GENERATORS[name]
    whole = cls.generate_device_batch

    def half(self, generator, batch):
        cond, target = whole(self, generator, batch)
        return cond[: batch // 2], target[: batch // 2]

    monkeypatch.setattr(cls, "generate_device_batch", half)


def _altered(monkeypatch, name):
    """An answer altered where it is produced."""
    predict = Forecaster.predict

    def altered(self, cond):
        out = predict(self, cond)
        out[-1] += 1e-3
        return out

    monkeypatch.setattr(Forecaster, "predict", altered)


@pytest.mark.parametrize("name,fault", [
    ("mnist_dcgan.train_f32", _still), ("mnist_dcgan.train_f32", _half),
    ("sst.train_f32", _still), ("sst.train_f32", _half),
    ("mnist_dcgan.serve_f32", _altered)], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    line = runner.run(tiny_job(name), 0.0)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_fail(name):
    job = tiny_job(name)
    drv = manifest.driver(job.traffic["driver"])
    for fault in drv.FAULTS:
        numbers, _ = drv.fault(job, fault)
        assert not judge(numbers, job.cell.spec["limits"])[0], fault


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place fails a limit."""
    job = tiny_job(name)
    numbers, _ = manifest.driver(job.traffic["driver"]).control(job)
    assert not judge(numbers, job.cell.spec["limits"])[0], numbers


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    """The control at the cell's own size on the card, on three seeds."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = manifest.find_cell(name)
    drv = manifest.driver(cell.traffic["driver"])
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers, _ = drv.control(Job.of(cell, seed, 0, False, card))
        assert not judge(numbers, cell.spec["limits"])[0], numbers
