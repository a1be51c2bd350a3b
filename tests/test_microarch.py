"""Micro-arch suite smoke tests: every bench runs at tiny sizes and emits
well-formed JSON naming its device — the regression harness contract
(reference analog: lib/gpu/*_testsuite executables)."""

import json

import numpy as np

import pytest

from libhpc_tpu.bench import microarch


def run_capture(capsys, fn, *args, **kw):
    fn(*args, **kw)
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    assert lines, "bench emitted no JSON"
    for d in lines:
        assert "bench" in d and "error" not in d, d
        assert d["platform"] == "cpu" and d["kind"] and "card" in d, d
    return lines


def test_gather_row_width(capsys):
    lines = run_capture(capsys, microarch.bench_gather_row_width,
                        n_rows=256, m=256)
    assert {d["b"] for d in lines} == {1, 8, 16, 128}
    assert all(d["g_rows_per_s"] > 0 for d in lines)


def test_scatter_modes(capsys):
    lines = run_capture(capsys, microarch.bench_scatter_modes, n=4096)
    assert {d["mode"] for d in lines} == {
        "scatter_add_dup", "scatter_perm", "gather_perm", "segment_sum"}


@pytest.mark.parametrize("name", list(microarch.ALL))
def test_registry_complete(name):
    assert callable(microarch.ALL[name])


def test_device_peaks_table():
    """Roofline peaks come from one table keyed by device_kind; a device
    missing from it is an error, never a default."""
    from libhpc_tpu.bench import harness

    h200 = harness.device_peaks("NVIDIA H200")
    assert h200["hbm_bytes_per_s"] == 4.8e12 and "data sheet" in h200["source"]
    with pytest.raises(KeyError, match="no published peaks"):
        harness.device_peaks("cpu")


@pytest.mark.parametrize("reply", ["NVIDIA H200, 700.00 W\n", None])
def test_card_line(monkeypatch, reply):
    """The card's name and power limit come from an nvidia-smi child
    process; without one the helper returns None."""
    import subprocess

    from libhpc_tpu.bench import harness

    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        if reply is None:
            raise FileNotFoundError(cmd[0])
        return subprocess.CompletedProcess(cmd, 0, stdout=reply, stderr="")

    monkeypatch.setattr(harness.subprocess, "run", fake_run)
    harness.card.cache_clear()
    try:
        assert harness.card() == (reply.strip() if reply else None)
    finally:
        harness.card.cache_clear()
