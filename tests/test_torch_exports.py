"""The port's package exports the JAX package's names
(``cloudsc2jax/__init__.py:10-38``), each resolved at its first use:
``import cloudsc2jax_torch`` in a fresh process loads no submodule and no
JAX, and every exported name resolves to the port's own object."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import json, sys
import cloudsc2jax_torch as c
loaded = sorted(m for m in sys.modules if m.startswith("cloudsc2jax_torch."))
resolved = {n: getattr(getattr(c, n), "__module__", None) for n in c.__all__}
print(json.dumps({"loaded": loaded, "all": c.__all__, "resolved": resolved,
                  "jax": [m for m in sys.modules
                          if m.split(".")[0] in ("jax", "cloudsc2jax")]}))
"""


def test_import_loads_no_physics_and_every_name_resolves():
    import cloudsc2jax

    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["loaded"] == [] and got["jax"] == []
    assert got["all"] == cloudsc2jax.__all__
    for name, module in got["resolved"].items():
        # the NCLV indices are ints, which have no module
        assert (module or "cloudsc2jax_torch.").startswith("cloudsc2jax_torch."), name
    assert got["resolved"]["NCLV"] is None
    assert got["resolved"]["cuadjtqs"] == "cloudsc2jax_torch.physics.cuadjtqs"
    assert got["resolved"]["cloudsc2_tl"] == "cloudsc2jax_torch.tlad"


def test_bare_import_loads_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, cloudsc2jax_torch; print(sorted(m for m in "
         "sys.modules if m.startswith('cloudsc2jax') or m == 'jax'))"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['cloudsc2jax_torch']"


def test_unknown_name_raises():
    import pytest

    import cloudsc2jax_torch

    with pytest.raises(AttributeError, match="no_such_name"):
        cloudsc2jax_torch.no_such_name
