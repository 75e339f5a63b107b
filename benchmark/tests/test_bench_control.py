"""The check fails what it must: the control (the reference in TF32 in the
program's place) and runs whose timed path is broken underneath, at
sizes a CPU test run holds."""

import numpy as np
import pytest
import torch

import sift3d_tpu_torch.registration as port_reg
from sift3d_tpu_torch import SIFT3D
from benchmark import control, harness

from _tiny import REGISTRATION, run, tiny_cell


@pytest.mark.parametrize("workload", ["sparse256-b16", REGISTRATION])
def test_control_in_tf32_is_not_correct(workload):
    """The reference in the program's place passes the run's own check in
    float32 and fails it in TF32."""
    cell = tiny_cell(workload)
    pool = harness.load("generators", cell.traffic["generator"]).make(
        cell.traffic["params"], 12345, "cpu")
    dev, lines = torch.device("cpu"), []

    def passed(prec):
        got = control.readings(cell, pool, 12345, dev,
                               control.reference_answer(cell, dev, prec),
                               lines.append)
        return [v <= lim for v, lim in got.values()]
    assert all(passed("f32")) and not all(passed("tf32"))


def _half(monkeypatch):
    """The batch's second half answered with the first half's results."""
    detect, describe = (SIFT3D.detect_keypoints_batch,
                        SIFT3D.extract_descriptors_batch)

    def det(self, vols, units=(1.0, 1.0, 1.0)):
        h = max(1, vols.shape[0] // 2)
        kps = detect(self, vols[:h], units)
        return kps + kps[:vols.shape[0] - h]

    def desc(self, kps):
        h = self._gpyr[0].shape[0]
        ds = describe(self, kps[:h])
        return ds + ds[:len(kps) - h]
    monkeypatch.setattr(SIFT3D, "detect_keypoints_batch", det)
    monkeypatch.setattr(SIFT3D, "extract_descriptors_batch", desc)


def _coordinate(monkeypatch):
    """Each volume's first keypoint one voxel off along x."""
    detect = SIFT3D.detect_keypoints_batch

    def det(self, vols, units=(1.0, 1.0, 1.0)):
        kps = detect(self, vols, units)
        for kp in kps:
            kp.coords[:1, 0] += 1.0
        return kps
    monkeypatch.setattr(SIFT3D, "detect_keypoints_batch", det)


def _descriptor(monkeypatch):
    """Each volume's first two descriptors swapped."""
    describe = SIFT3D.extract_descriptors_batch

    def desc(self, kps):
        ds = describe(self, kps)
        for d in ds:
            d.data[:2] = d.data[:2][::-1].copy()
        return ds
    monkeypatch.setattr(SIFT3D, "extract_descriptors_batch", desc)


def _affine(monkeypatch):
    """Every pair's affine shifted by a voxel along x."""
    pairs = port_reg._register_pairs

    def fit(*args, **kw):
        out = pairs(*args, **kw)
        for r in out:
            if r.affine is not None:
                r.affine = r.affine + np.float32([[0, 0, 0, 1]] * 3)
        return out
    monkeypatch.setattr(port_reg, "_register_pairs", fit)


FAULTS = [("sparse256-b16", _half), ("sparse256-b16", _coordinate),
          ("sparse256-b16", _descriptor), (REGISTRATION, _half),
          (REGISTRATION, _coordinate), (REGISTRATION, _affine)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result, _, lines = run(workload)
    assert result["correct"] is False, lines[-8:]
    assert result["failed"] > 0
