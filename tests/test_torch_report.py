"""repro_torch.analysis.report's codec table and the small public helpers
against the reference (repro.analysis.report, repro.core.filter,
repro.core.rates, repro.core.compressors, repro.configs.registry).

The codec table's values are the port's own draws, so they are held to the
bounds of tests/test_torch_codecs.py (the JAX package's contraction test),
not to the reference's numbers; its rows come in the reference's order.
"""

import os
import subprocess
import sys

import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import compressors as jcomp
from repro.core import filter as jfilter
from repro.core import rates as jrates
from repro.core.state import CODECS as JCODECS
from repro_torch.analysis import report
from repro_torch.configs import registry
from repro_torch.core import compressors as tcomp
from repro_torch.core import filter as tfilter
from repro_torch.core import rates as trates

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# per-step bound of each codec (tests/test_torch_codecs.py); drift under ten times it
BOUNDS = {"fp32": 1e-12, "bf16": 6e-3, "fp8": 6e-2, "fp8_ec": 5e-4}


def _rows(table: str) -> dict:
    """{codec: (worst step, last step, drift)} from the markdown table."""
    out = {}
    for line in table.splitlines()[2:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        out[cells[0]] = tuple(float(c) for c in cells[1:])
    return out


@pytest.fixture(scope="module")
def table():
    return report.codec_table(device="cpu")


def test_codec_rows_in_the_reference_order(table):
    lines = table.splitlines()
    assert lines[0] == "| codec | worst step err | last step err | drift vs fp32 |"
    assert list(_rows(table)) == list(JCODECS)


@pytest.mark.parametrize("name", list(BOUNDS))
def test_codec_values_within_the_bounds(table, name):
    worst, last, drift = _rows(table)[name]
    assert 0 <= last <= worst < BOUNDS[name]
    assert drift < max(10 * BOUNDS[name], 1e-12)


def test_codec_steps_argument():
    rows = _rows(report.codec_table(steps=2, device="cpu"))
    assert list(rows) == list(JCODECS) and rows["fp32"] == (0.0, 0.0, 0.0)


def test_report_cli_prints_the_codec_table():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report", "--codecs",
                          "--codec-steps", "3", "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("## Residue codec roundtrip")
    assert list(_rows(out.stdout.split("\n\n", 1)[1])) == list(JCODECS)


def test_codec_table_runs_on_the_card_by_default(monkeypatch):
    """Without ``device`` the table asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        report.codec_table(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        report.main(["--codecs", "--codec-steps", "1"])


def test_report_cli_without_codecs_exits_saying_so():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.report"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "only --codecs" in out.stderr


@pytest.mark.parametrize("gamma", [0.0, 0.1, 0.5, 0.9, 0.999, 1.0, 1.5])
def test_beta_band(gamma):
    got, want = tfilter.beta_band(gamma), jfilter.beta_band(gamma)
    assert got == want and got[0] <= got[1]


def test_paper_guidance_chunk_and_lm_flops_per_grad():
    assert trates.PAPER_TIERS == jrates.PAPER_TIERS
    for ratio in (0.0, 1.0, 127.9, 128.0, 195.99, 196.0, 1e6, -1.0):
        assert trates.paper_guidance_chunk(ratio) == jrates.paper_guidance_chunk(ratio)
    for tokens in (1, 64, 98, 512, 4096):
        assert trates.lm_flops_per_grad(tokens) == jrates.lm_flops_per_grad(tokens)
    # 512 tokens a worker: the conservative 25x tier
    assert trates.paper_guidance_chunk(trates.lm_flops_per_grad(512)) == 25


@pytest.mark.parametrize("chunk,topm", [(64, 1), (64, 2), (25, 1), (400, 8)])
def test_compression_rate(chunk, topm):
    t = tcomp.CompressorConfig("clt_k", chunk=chunk, topm=topm)
    j = jcomp.CompressorConfig("clt_k", chunk=chunk, topm=topm)
    assert tcomp.compression_rate(t) == jcomp.compression_rate(j) == t.rate == chunk / topm


def test_all_archs():
    got, want = registry.all_archs(), jregistry.all_archs()
    assert list(got) == list(want)
    for name, cfg in got.items():
        for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab"):
            assert getattr(cfg, f) == getattr(want[name], f), (name, f)
