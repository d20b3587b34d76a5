"""Model/Data text dumps, the debugging workhorse.

Port of the JAX package's ``utils/printer.py``, the analog of
``mj_printModel`` / ``mj_printData`` (reference
``src/engine/engine_print.c:892/1432``): one generic walker over the
port's dataclasses (``Model``, ``Data``, ``Contact``, ``Option``, ...)
renders every field, tensors from any device.  A ``Data`` prints with its
fleet dimension first.

Usage::

    from mujoco_inversedynamicstest_tpu_torch.utils import printer
    printer.print_model(m)                    # to stdout
    printer.print_data(d, "dump.txt")         # to a file
    s = printer.format_pytree(anything)       # to a string
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, Optional

import numpy as np
import torch

_FLOAT_FORMAT = "%.6g"


def _host(v) -> Optional[np.ndarray]:
  """A tensor or numpy array as a host array; None for anything else."""
  if isinstance(v, torch.Tensor):
    return v.detach().cpu().numpy()
  if isinstance(v, np.ndarray):
    return v
  return None


def _fmt_array(a: np.ndarray, float_format: str, indent: str,
               max_rows: int) -> str:
  if a.ndim == 0:
    if np.issubdtype(a.dtype, np.floating):
      return float_format % float(a)
    return str(a)
  flat2d = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(-1, 1)
  lines = []
  n = flat2d.shape[0]
  shown = min(n, max_rows)
  for i in range(shown):
    row = flat2d[i]
    if np.issubdtype(a.dtype, np.floating):
      cells = " ".join(float_format % v for v in row)
    else:
      cells = " ".join(str(v) for v in row)
    lines.append(f"{indent}{i:<5d} {cells}")
  if shown < n:
    lines.append(f"{indent}... ({n - shown} more rows)")
  return "\n".join(lines)


def _write_array(out, indent: str, name: str, a: np.ndarray,
                 float_format: str, max_rows: int) -> None:
  out.write(f"{indent}{name}  {a.dtype}{list(a.shape)}\n")
  if a.size:
    out.write(_fmt_array(a, float_format, indent + "  ", max_rows) + "\n")


def format_pytree(obj: Any, name: str = "", float_format: str = _FLOAT_FORMAT,
                  max_rows: int = 10_000, _depth: int = 0) -> str:
  """Renders a dataclass (Model, Data, Contact, ...), a NamedTuple or an
  array as indented text.  Fields not in the dataclass's repr (caches,
  the model's snapshot) are left out."""
  out = io.StringIO()
  indent = "  " * _depth
  title = name or type(obj).__name__

  if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    out.write(f"{indent}{title.upper()}\n")
    for f in dataclasses.fields(obj):
      v = getattr(obj, f.name)
      if v is None or not f.repr:
        continue
      a = _host(v)
      if dataclasses.is_dataclass(v) and not isinstance(v, type):
        out.write(format_pytree(v, f.name, float_format, max_rows,
                                _depth + 1))
      elif isinstance(v, (tuple, list)) and v and not isinstance(
          v[0], (int, float, str, np.integer, np.floating)):
        out.write(f"{indent}  {f.name}: <{len(v)} entries>\n")
      elif a is not None:
        _write_array(out, indent + "  ", f.name, a, float_format, max_rows)
      elif hasattr(v, "_fields"):  # NamedTuple
        out.write(f"{indent}  {f.name}:\n")
        for fn2 in v._fields:
          v2 = getattr(v, fn2)
          a2 = _host(v2)
          if a2 is not None:
            _write_array(out, indent + "    ", fn2, a2, float_format,
                         max_rows)
          else:
            out.write(f"{indent}    {fn2}: {v2}\n")
      else:
        out.write(f"{indent}  {f.name}: {v}\n")
  elif hasattr(obj, "_fields"):
    out.write(f"{indent}{title.upper()}\n")
    for fn2 in obj._fields:
      out.write(format_pytree(getattr(obj, fn2), fn2, float_format,
                              max_rows, _depth + 1))
  elif _host(obj) is not None:
    _write_array(out, indent, title, _host(obj), float_format, max_rows)
  else:
    out.write(f"{indent}{title}: {obj}\n")
  return out.getvalue()


def _emit(text: str, filename: Optional[str]) -> None:
  if filename is None:
    print(text, end="")
  else:
    with open(filename, "w") as f:
      f.write(text)


def print_model(m, filename: Optional[str] = None,
                float_format: str = _FLOAT_FORMAT) -> None:
  """Full Model dump (``mj_printFormattedModel`` analog, ref :342)."""
  header = (f"MODEL nq={m.nq} nv={m.nv} nu={m.nu} na={m.na} "
            f"nbody={m.nbody} njnt={m.njnt} ngeom={m.ngeom} "
            f"neq={m.neq} ntendon={m.ntendon} nsensor={m.nsensor} "
            f"dtype={str(m.dtype).removeprefix('torch.')}\n\n")
  _emit(header + format_pytree(m, "model", float_format), filename)


def print_data(d, filename: Optional[str] = None,
               float_format: str = _FLOAT_FORMAT) -> None:
  """Full Data dump (``mj_printFormattedData`` analog, ref :899), the
  fleet dimension first."""
  _emit(format_pytree(d, "data", float_format), filename)
