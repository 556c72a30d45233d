"""The architectures the benchmark can run, each found by the name in its
configuration's `model.arch`: `archs/<arch>.py`. A new architecture is a
new file here, beside its configuration, traffic and cells.

An architecture module provides, each taking the configuration's `model`
dict (`arch`) first:

  * `param_shapes(arch)`: name -> (shape, init tag) of every parameter,
    under the names of the port's `state_dict` (`weights.make_weights`
    reads the tags);
  * `stat_names(arch)`: the prefixes of the running statistics (each
    `<prefix>.scale` a parameter), `[]` for a model without any;
  * `head_bias(arch)`: the name of the bias of the head whose output is the
    logits, which `weights.balance_classes` shifts;
  * `Net`: the plain float32 reference forward, called as
    `Net(arch, params, bn_mode, quant=None, stats=None, remat=False)(x,
    keep=None)` -> logits (B, classes, D, H, W), with `batch_stats` after a
    'slab' or 'async' forward (see `reference/model.py`);
  * `parameter_count(arch)`, `forward_flops(arch, batch, spatial)` (the
    FLOPs of one forward, counted as `flops.py` counts them) and
    `dw_calls(arch, batch, spatial)` (((B, D, H, W, C), stride) of each
    depthwise conv of a forward; `[]` for none);
  * optionally `make_weights(arch, seed, device, served)` and `run_steps(...)`
    (the signature of `reference/train.py::run_steps`), which then take the
    place of those two functions for this architecture.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z][A-Za-z0-9_]{0,63}")


def load(arch: dict):
    """-> the module `archs/<arch["arch"]>.py`."""
    name = arch["arch"]
    if not NAME.fullmatch(name) or not (HERE / f"{name}.py").is_file():
        known = sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")
        raise ValueError(f"no architecture {name!r}: expected {HERE / (name + '.py')}; "
                         f"known: {known}")
    return importlib.import_module(f"{__name__}.{name}")
