"""The CLI's two ``tlad`` routes (``cloudsc2jax/cli.py:582-620``), on the
CPU.

* Without ``--kernels``: the truth path, ``run_tlad(backend="truth",
  nproma=nproma if nproma < ngptot else None)``: ``tlad 1 100 25 --dtype
  f64`` runs the unit in four NPROMA blocks of 25 columns and passes the
  adjoint identity at 1e-10.
* With ``--kernels``: the stream contract, ``run_tlad(backend="streams")``
  (the plain versions of the TL and AD kernels here), one unit over all
  columns.

Both read a synthetic store of 100 columns and 13 levels (``--input``), so
that the truth path's four units stay cheap on the host.
"""

import pytest

from cloudsc2jax import io as jio
from cloudsc2jax_torch import cli, drivers


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    raw, params = jio.synthetic_state(nlon=100, nlev=13)
    path = tmp_path_factory.mktemp("routes") / "input.npz"
    jio.write_input_h5(path, raw, params)
    return str(path)


@pytest.fixture
def spied(monkeypatch):
    """The backends and NPROMA blocks of every ``run_tlad`` call, and the
    columns of every truth-path unit, as the CLI makes them."""
    seen = {"run_tlad": [], "units": []}
    run_tlad, unit = drivers.run_tlad, drivers._truth_unit

    def spy_run_tlad(inputs, params, **kw):
        if kw.get("mesh") is None:
            seen["run_tlad"].append((kw.get("backend", "streams"), kw.get("nproma")))
        return run_tlad(inputs, params, **kw)

    def spy_unit(inputs, params, **kw):
        seen["units"].append(inputs.pt.shape[0])
        return unit(inputs, params, **kw)

    monkeypatch.setattr(drivers, "run_tlad", spy_run_tlad)
    monkeypatch.setattr(drivers, "_truth_unit", spy_unit)
    return seen


def test_cli_tlad_truth_route_in_nproma_blocks(spied, store, capsys):
    assert cli.main(["tlad", "1", "100", "25", "--dtype", "f64", "--device", "cpu",
                     "--input", store]) == 0
    assert spied["run_tlad"] == [("truth", 25)]
    assert spied["units"] == [25, 25, 25, 25]
    err = capsys.readouterr().err
    assert "tlad outputs finite: True" in err and "(tol 1e-10)" in err


def test_cli_tlad_kernels_route(spied, store, capsys):
    assert cli.main(["tlad", "1", "100", "25", "--dtype", "f64", "--device", "cpu",
                     "--input", store, "--kernels"]) == 0
    assert spied["run_tlad"] == [("streams", None)] and spied["units"] == []
    assert "tlad outputs finite: True" in capsys.readouterr().err
