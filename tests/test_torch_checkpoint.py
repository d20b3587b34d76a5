"""The port's checkpoints and text dumps (``utils/checkpoint.py``,
``utils/printer.py``): the JAX package's ``tests/test_checkpoint.py`` on the
port, bit-exact where those are.

A stepped fleet survives save and restore bit for bit and the restored
model steps it to the same next state; a fleet MPC resumed from a
checkpoint equals the uninterrupted run bit for bit; ``strict`` refuses a
shape mismatch and a missing leaf; the dumps render the load-bearing
fields.  On a card: a checkpoint written from the CPU restores onto a
template on the card, bit for bit.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.opt import mpc, northstar
from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import ILQRConfig
from mujoco_inversedynamicstest_tpu_torch.utils import checkpoint as ckpt
from mujoco_inversedynamicstest_tpu_torch.utils import printer
from mujoco_inversedynamicstest_tpu_torch.utils import tree

from models import PENDULUM
from test_checkpoint import ARM


def _pendulum_fleet(steps: int = 5):
  m = mt.put_model(mujoco.MjModel.from_xml_string(PENDULUM), device="cpu")
  d = mt.make_data(m, 2)
  d = d.replace(qvel=torch.full_like(d.qvel, 0.3))
  for _ in range(steps):
    d = mt.step(m, d)
  return m, d


def test_data_roundtrip_bitexact(tmp_path):
  """A stepped fleet survives save/restore bit-exactly."""
  m, d = _pendulum_fleet()
  ckpt.save(str(tmp_path / "c"), m, d)
  m2 = ckpt.load_model(str(tmp_path / "c"), device="cpu")
  assert m2.dtype == m.dtype
  d2 = ckpt.restore(str(tmp_path / "c"), mt.make_data(m2, 2))
  saved = dict(tree.leaves_with_path(d))
  restored = list(tree.leaves_with_path(d2))
  assert len(restored) > 10
  for path, leaf in restored:
    assert torch.equal(leaf, saved[path]), path

  # ...and the restored model steps it to the identical next state
  a, b = mt.step(m, d), mt.step(m2, d2)
  assert torch.equal(a.qpos, b.qpos) and torch.equal(a.qvel, b.qvel)


def test_mpc_resume_bitexact(tmp_path):
  """Resuming a fleet MPC from a checkpoint = running it uninterrupted."""
  mjm = mujoco.MjModel.from_xml_string(ARM)
  m = mt.put_model(mjm, device="cpu")
  cost = northstar.balance_cost(m, w_root=0.0)
  cfg = mpc.MPCConfig(horizon=8, ilqr=ILQRConfig(iterations=2, n_alpha=3),
                      n_apply=1)
  fleet = 3
  qpos = torch.as_tensor(0.2 * np.random.RandomState(2).randn(fleet, m.nq))
  batch = mt.make_data(m, fleet).replace(qpos=qpos)
  one_cycle = lambda mm, c: mpc.mpc_step(mm, cost, c, cfg).carry
  warm = mpc.make_warm_start(m, cfg.horizon, fleet)
  carry = mpc.MPCCarry(d=batch, us_warm=warm)

  ref = one_cycle(m, one_cycle(m, carry))                 # uninterrupted

  mid = one_cycle(m, carry)                               # interrupted
  ckpt.save(str(tmp_path / "mpc"), m, mid)
  m2 = ckpt.load_model(str(tmp_path / "mpc"), device="cpu")
  template = mpc.MPCCarry(d=mt.make_data(m2, fleet).replace(qpos=qpos),
                          us_warm=warm)
  res = one_cycle(m2, ckpt.restore(str(tmp_path / "mpc"), template))

  for a, b in ((ref.d.qpos, res.d.qpos), (ref.d.qvel, res.d.qvel),
               (ref.us_warm, res.us_warm)):
    assert torch.equal(a, b)


def test_restore_strict_shape_mismatch(tmp_path):
  m = mt.put_model(mujoco.MjModel.from_xml_string(PENDULUM), device="cpu")
  d = mt.make_data(m, 1)
  ckpt.save(str(tmp_path / "c"), m, {"qpos": d.qpos})
  with pytest.raises(ValueError, match="shape"):
    ckpt.restore(str(tmp_path / "c"), {"qpos": torch.zeros(1, m.nq + 1)})
  with pytest.raises(KeyError):
    ckpt.restore(str(tmp_path / "c"), {"other": d.qpos})
  out = ckpt.restore(str(tmp_path / "c"), {"other": d.qpos}, strict=False)
  assert out["other"] is d.qpos


def test_print_model_and_data(tmp_path):
  """mj_printModel/printData analog: complete text dumps render and
  contain the load-bearing fields."""
  m = mt.put_model(mujoco.MjModel.from_xml_string(PENDULUM), device="cpu")
  d = mt.forward(m, mt.make_data(m, 2))

  p = tmp_path / "model.txt"
  printer.print_model(m, str(p))
  text = p.read_text()
  assert "MODEL nq=1" in text and "qpos0" in text and "geom_size" in text
  assert "dtype=float64" in text

  p2 = tmp_path / "data.txt"
  printer.print_data(d, str(p2))
  t2 = p2.read_text()
  for field in ("qpos", "qvel", "qacc", "qM", "xpos", "sensordata"):
    assert f"  {field}  " in t2, field
  assert "qpos  float64[2, 1]" in t2
  assert "%.6g" % float(d.qacc[0, 0]) in t2


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.mark.gpu
def test_cpu_checkpoint_restores_onto_the_card(cuda, tmp_path):
  m, d = _pendulum_fleet()
  ckpt.save(str(tmp_path / "c"), m, d)
  m2 = ckpt.load_model(str(tmp_path / "c"), device=cuda)
  d2 = ckpt.restore(str(tmp_path / "c"), mt.make_data(m2, 2))
  saved = dict(tree.leaves_with_path(d))
  for path, leaf in tree.leaves_with_path(d2):
    assert leaf.device.type == "cuda"
    assert torch.equal(leaf.cpu(), saved[path]), path
