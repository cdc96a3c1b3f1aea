"""The port's multi-process column decomposition, executed: processes that
join one ``gloo`` group over ``localhost`` on the CPU (the plain versions),
as ``tests/test_multiprocess.py`` drives the JAX package's, and each held
against one process over the same columns.

* the CLI with ``CLOUDSC2_NUM_PROCESSES=2``: rank 0 prints the gathered
  per-rank table (``TOTAL @ rank#`` rows and the ``2proc`` total) and the
  golden verdict, equal to one process's; every rank exits 0;
  ``--per-device-timing`` prints measured rows;
* in two processes of two CPU lanes each: ``run_chunked(mesh=)``'s checksum,
  ``validate_device(mesh=, col_offset=)``'s statistics and the timer's
  gathered table.

Every process has a time limit; a rank that hangs fails the test.  The
four-process ``tlad`` case is marked ``slow``: four ranks of the plain TL
and AD sweeps take ~4x the host's cores of the two-process cases.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cloudsc2jax_torch import validate as tval
from cloudsc2jax_torch.drivers import run_chunked, run_nl
from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs
from cloudsc2jax_torch.state import Cloudsc2State

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
TIMEOUT_S = 240

_WORKER = r"""
import json, sys
import torch
from cloudsc2jax_torch import dist
from cloudsc2jax_torch import validate as tval
from cloudsc2jax_torch.drivers import run_chunked, run_nl
from cloudsc2jax_torch.kernels.cloudsc2_kernel import unblock_outputs
from cloudsc2jax_torch.state import Cloudsc2State
from cloudsc2jax_torch.timer import PerformanceTimer

assert dist.initialize()
mesh = dist.column_mesh("cpu", 2)
assert (mesh.world, mesh.size) == (2, 4)
res = {"rank": mesh.rank}
syn = Cloudsc2State.synthetic(ngptot=100, nlev=9)
res["nl"] = run_chunked(syn, 2048, variant="nl", chunk=1024, sublanes=1,
                        device="cpu", mesh=mesh)
res["tlad"] = run_chunked(syn, 1024, variant="tlad", chunk=1024, sublanes=1,
                          device="cpu", mesh=mesh)

st = Cloudsc2State.load(sys.argv[1])
ngptot = dist.pad_columns(202, mesh)
slices = dist.lane_slices(ngptot, mesh)
lanes = [st.device_kernel_inputs(s.stop - s.start, dtype=torch.float64,
                                 device=d, col_offset=s.start)
         for d, s in zip(mesh.lanes, slices)]
seen = {}
tval.print_validation = lambda e, threshold=10.0, file=None: (
    seen.update(e) or all(x.passed(threshold) for x in e.values()))
out = [unblock_outputs(o, st.params) for o in run_nl(lanes, st.params, mesh=mesh)]
res["verdict"] = st.validate_device(out, lanes, sys.argv[2], mesh=mesh,
                                    col_offset=slices[0].start)
res["stats"] = {k: [e.zminval, e.zmaxval, e.zmaxerr, e.zerrsum, e.zsum, e.ngptot]
                for k, e in seen.items()}

timer = PerformanceTimer(mesh.lanes)
timer.start(mesh.nlanes)
timer.thread_start(0)
timer.spmd_log(mesh.nlanes, ngptot // mesh.world)
timer.thread_end(0)
timer.mirror_times(mesh.nlanes)
timer.end()
timer.print_performance(100, 3, ngptot, file=sys.stdout, gather=True)
print("RESULT " + json.dumps(res), flush=True)
dist.finalize()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(nproc: int, args, timeout: float = TIMEOUT_S):
    """``args`` (``python`` arguments) in ``nproc`` processes of one group;
    returns ``[(exit code, stdout, stderr)]`` by rank.  Any process still
    running at ``timeout`` is killed and the test fails."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = {**os.environ, "CLOUDSC2_NUM_PROCESSES": str(nproc),
               "CLOUDSC2_PROCESS_ID": str(rank),
               "CLOUDSC2_COORDINATOR": f"localhost:{port}"}
        procs.append(subprocess.Popen(
            [sys.executable, *args], env=env, cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len(results) == nproc, "a rank hung"
    return results


def _cli(nproc: int, argv):
    return _launch(nproc, ["-m", "cloudsc2jax_torch", *argv, "--device", "cpu"])


def _validation_rows(text: str) -> dict:
    """Field -> the five numbers of the validation table, and its flag."""
    rows = {}
    for line in text.splitlines():
        m = re.match(r"\s*([A-Z_]+)\s+\d\s+((?:\S+\s+){4}\S+)(\s+!!!!)?$", line)
        if m:
            rows[m.group(1)] = ([float(x) for x in m.group(2).split()],
                                bool(m.group(3)))
    return rows


# --------------------------------------------------------- the CLI, nl
NL_ARGV = ["nl", "1", "200", "100"]


@pytest.fixture(scope="module")
def nl_runs():
    """The nl CLI over 200 columns: two ranks, then one process."""
    one = subprocess.run([sys.executable, "-m", "cloudsc2jax_torch", *NL_ARGV,
                          "--device", "cpu"], cwd=REPO, text=True,
                         capture_output=True, timeout=TIMEOUT_S,
                         env={k: v for k, v in os.environ.items()
                              if not k.startswith("CLOUDSC2_")})
    return _cli(2, NL_ARGV), (one.returncode, one.stdout, one.stderr)


def test_cli_nl_two_processes_exit_zero(nl_runs):
    two, one = nl_runs
    assert [rc for rc, _, _ in two] == [0, 0], [e for _, _, e in two]
    assert one[0] == 0


def test_cli_nl_two_processes_gathered_table(nl_runs):
    """Rank 0 prints the set-up line, one row per rank's lane, a ``TOTAL @
    rank#`` row per rank and the ``2proc`` total; rank 1 prints no table."""
    (_, _, err0), (_, _, err1) = nl_runs[0]
    assert "NUMPROC=2, NUMDEV=1, NGPTOTG=200" in err0
    assert re.search(r"^\s+0:0\s+200\s+100\s", err0, re.M)
    assert re.search(r"^\s+1:0\s+200\s+100\s", err0, re.M)
    assert err0.count("TOTAL @ rank#") == 2
    assert "TOTAL @ rank#1" in err0
    assert re.search(r"^\s+2proc\s+200\s+200\s.*TOTAL$", err0, re.M)
    assert "TOTAL" not in err1 and "TENDENCY_LOC_T" not in err1


def test_cli_nl_two_processes_verdict_equals_one_process(nl_runs):
    """The same golden verdict over the same 200 columns, every field
    unflagged, each statistic of the table equal to one process's to its
    printed digits (the sums reassociate by rank)."""
    (_, _, err0), _ = nl_runs[0]
    mine, theirs = _validation_rows(err0), _validation_rows(nl_runs[1][2])
    assert len(mine) == 10 and list(mine) == list(theirs)
    for k, (vals, flag) in mine.items():
        assert not flag and not theirs[k][1], k
        np.testing.assert_allclose(vals, theirs[k][0], rtol=1e-11, atol=1e-300,
                                   err_msg=k)


def test_cli_nl_two_processes_per_device_timing():
    """``--per-device-timing`` re-times each rank's lane on its device: the
    gathered rows are ``(measured)``, no longer mirrors."""
    (rc0, _, err0), (rc1, _, err1) = _cli(2, NL_ARGV + ["--kernels",
                                                        "--per-device-timing"])
    assert (rc0, rc1) == (0, 0), err0 + err1
    rows = [line for line in err0.splitlines() if re.match(r"\s+\d:\d\s", line)]
    assert len(rows) == 2 and all(line.endswith("(measured)") for line in rows)


def test_per_device_timing_on_one_lane_is_ignored(capsys):
    """One lane of one process has nothing to re-time: the JAX CLI's line."""
    from cloudsc2jax_torch import cli

    assert cli.main(["nl", "1", "100", "100", "--device", "cpu", "--kernels",
                     "--per-device-timing"]) == 0
    assert ("--per-device-timing needs a multi-device or multi-process run "
            "— ignored") in capsys.readouterr().err


def test_cli_nl_two_lanes_measured(capsys):
    """Two CPU lanes in one process: mirrored rows, or measured ones with
    ``--per-device-timing``."""
    from cloudsc2jax_torch import cli

    assert cli.main(["nl", "2", "200", "100", "--device", "cpu", "--kernels"]) == 0
    err = capsys.readouterr().err
    assert "NUMPROC=1, NUMDEV=2" in err and err.count("(mirror)") == 1
    assert cli.main(["nl", "2", "200", "100", "--device", "cpu", "--kernels",
                     "--per-device-timing"]) == 0
    assert capsys.readouterr().err.count("(measured)") == 2


# --------------------------------------------------------- the CLI, tlad
def test_cli_tlad_two_processes():
    """The TL+AD unit over two ranks, f64: the adjoint identity reduced over
    the group passes on every rank, printed once."""
    runs = _cli(2, ["tlad", "1", "64", "64", "--dtype", "f64", "--kernels"])
    assert [rc for rc, _, _ in runs] == [0, 0], [e for _, _, e in runs]
    assert runs[0][2].count("adjoint identity rel err") == 1
    assert "adjoint identity" not in runs[1][2]


@pytest.mark.slow
def test_cli_tlad_four_processes():
    runs = _cli(4, ["tlad", "1", "64", "64", "--dtype", "f64", "--kernels"])
    assert [rc for rc, _, _ in runs] == [0] * 4, [e for _, _, e in runs]
    assert runs[0][2].count("TOTAL @ rank#") == 4


# ------------------------------------- library calls, 2 ranks x 2 lanes
@pytest.fixture(scope="module")
def worker():
    runs = _launch(2, ["-c", _WORKER, str(FIXTURES / "input.npz"),
                       str(FIXTURES / "reference.npz")])
    out = []
    for rc, stdout, stderr in runs:
        assert rc == 0, stderr
        (line,) = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
        out.append((json.loads(line[7:]), stdout))
    return out


def test_run_chunked_two_ranks_equals_one_process(worker):
    """Four lanes over two ranks: every rank returns the same checksum,
    within 1e-5 (nl) and 1e-4 (tlad) of one process over the same columns."""
    syn = Cloudsc2State.synthetic(ngptot=100, nlev=9)
    (a, _), (b, _) = worker
    for variant, n, rtol in (("nl", 2048, 1e-5), ("tlad", 1024, 1e-4)):
        assert a[variant] == b[variant]
        cols, ref = run_chunked(syn, n, variant=variant, chunk=1024, sublanes=1,
                                device="cpu")
        assert a[variant][0] == cols == n
        np.testing.assert_allclose(a[variant][1], ref, rtol=rtol)


def test_validate_device_two_ranks_equals_one_process(worker, monkeypatch):
    """The validation statistics of 204 columns over four lanes in two
    ranks (each lane's golden columns tiled from its global offset): the
    same verdict on both ranks, MIN and MAX equal to one process's exactly,
    the sums to 1e-12."""
    (a, _), (b, _) = worker
    assert a["verdict"] is True and b["verdict"] is True
    assert a["stats"] == b["stats"]
    st = Cloudsc2State.load(FIXTURES / "input.npz")
    seen = {}
    monkeypatch.setattr(tval, "print_validation",
                        lambda e, threshold=10.0, file=None: seen.update(e) or True)
    x = st.device_kernel_inputs(204, dtype=torch.float64, device="cpu")
    st.validate_device(unblock_outputs(run_nl(x, st.params), st.params), x,
                       FIXTURES / "reference.npz")
    for k, e in seen.items():
        mn, mx, maxerr, errsum, tot, n = a["stats"][k]
        assert (mn, mx, maxerr, n) == (e.zminval, e.zmaxval, e.zmaxerr, 204), k
        assert abs(errsum - e.zerrsum) <= 1e-12 * max(e.zerrsum, 1e-300), k
        assert abs(tot - e.zsum) <= 1e-12 * max(e.zsum, 1e-300), k


def test_timer_gathers_every_rank_to_rank_zero(worker):
    (_, out0), (_, out1) = worker
    for row in ("0:0", "0:1", "1:0", "1:1"):
        assert re.search(rf"^\s+{row}\s+204\s+51\s+1\s", out0, re.M), row
    assert out0.count("(mirror)") == 2
    assert "TOTAL @ rank#0" in out0 and "TOTAL @ rank#1" in out0
    assert re.search(r"^\s+2proc\s+204\s+204\s.*TOTAL$", out0, re.M)
    assert "TOTAL" not in out1
