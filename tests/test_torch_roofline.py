"""The port's roofline (``repro_torch.roofline``) against the reference's:
``param_count`` and ``model_flops`` ``==`` for every architecture and
shape, ``roofline_row`` ``==`` with the port's H100 constants set to the
reference's values, the report's tables over one fixed set of rows (every
column equal but the hint, which names the card), and
``collective_bytes`` against bytes counted by hand on 4 gloo ranks (one
world in a subprocess of its own session, ``mesh_check.run``: this
process joins no process group)."""
import pytest

import mesh_check
from mesh_check import case
from repro.configs import ARCHS, SHAPES, get_arch as ref_get_arch
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro_torch.configs import get_arch
from repro_torch.roofline import analysis, report

WORLD = 4
CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_param_count_and_model_flops_equal_the_reference(arch, shape):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    assert analysis.param_count(cfg) == ref_analysis.param_count(ref_cfg)
    assert analysis.model_flops(cfg, SHAPES[shape]) == \
        ref_analysis.model_flops(ref_cfg, SHAPES[shape])


# per-device counts under which each term dominates in turn (at either
# set of constants)
ROWS = [
    {"n_chips": 256, "flops": 1.26e15, "bytes_accessed": 4.0e11,
     "collective_bytes": 1.05e10},
    {"n_chips": 256, "flops": 3.0e10, "bytes_accessed": 4.0e13,
     "collective_bytes": 1.8e9},
    {"n_chips": 512, "flops": 1.5e10, "bytes_accessed": 2.0e10,
     "collective_bytes": 9.6e11},
    {"n_chips": 256, "flops": 0.0, "bytes_accessed": 0.0,
     "collective_bytes": 0.0},
]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_row_equals_the_reference_at_its_constants(
        monkeypatch, arch, shape):
    for name, ref_name in (("PEAK_FLOPS", "PEAK_FLOPS"), ("HBM_BW", "HBM_BW"),
                           ("LINK_BW", "LINK_BW"), ("LINKS", "ICI_LINKS")):
        monkeypatch.setattr(analysis, name, getattr(ref_analysis, ref_name))
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    for row in ROWS:
        assert analysis.roofline_row(cfg, SHAPES[shape], row) == \
            ref_analysis.roofline_row(ref_cfg, SHAPES[shape], row)


def test_h100_constants_and_the_float32_peak():
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_FP32, analysis.HBM_BW,
            analysis.LINK_BW, analysis.LINKS) == (989e12, 67e12, 3.35e12,
                                                  50e9, 1)
    assert analysis.HBM_PER_CHIP == 80 * 2**30
    cfg, row = get_arch("granite-3-2b"), ROWS[0]
    fp32 = analysis.roofline_row(cfg, SHAPES["train_4k"], row,
                                 peak_flops=analysis.PEAK_FLOPS_FP32)
    assert fp32["compute_s"] == row["flops"] / 67e12
    assert analysis.roofline_row(cfg, SHAPES["train_4k"], row)[
        "compute_s"] == row["flops"] / 989e12


def _report_rows(tmp_path, mod):
    """One fixed set of rows (ok, skipped and errored cells on both
    meshes, with the roofline fields from ``mod``'s ``roofline_row``),
    written as JSONL and read back by the report's ``load``."""
    import json

    lines = []
    for i, (arch, shape) in enumerate([("granite-3-2b", "train_4k"),
                                       ("yi-6b", "decode_32k"),
                                       ("mamba2-780m", "prefill_32k"),
                                       ("whisper-tiny", "decode_32k")]):
        base = dict(ROWS[i % 3], kind=SHAPES[shape].kind, status="ok",
                    arch=arch, shape=shape, compile_s=1.5 + i,
                    argument_bytes_per_device=3.2e9 * (i + 1),
                    peak_bytes_per_device=7.7e9 * (i + 1))
        cfg = ref_get_arch(arch)
        sp = {**base, "mesh": "16x16", "collective_bytes_scaled":
              base["collective_bytes"] * 2,
              **ref_analysis.roofline_row(cfg, SHAPES[shape], base)}
        mp = {**base, "mesh": "2x16x16", "n_chips": 512, "compile_s": 9.0}
        lines += [sp, mp]
    lines.append({"arch": "yi-6b", "shape": "long_500k", "mesh": "16x16",
                  "status": "skipped", "reason": "full attention"})
    lines.append({"arch": "yi-6b", "shape": "prefill_32k", "mesh": "16x16",
                  "status": "error", "error": "boom"})
    path = tmp_path / f"{mod.__name__.replace('.', '_')}.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in lines) + "\nnot json\n")
    return mod.load(str(path))


def _cells(table: str) -> list[list[str]]:
    return [line.split("|") for line in table.splitlines()]


def test_report_tables_equal_the_reference_but_the_hints(tmp_path):
    rows, ref_rows = _report_rows(tmp_path, report), \
        _report_rows(tmp_path, ref_report)
    assert rows == ref_rows
    assert report.dryrun_table(rows) == ref_report.dryrun_table(ref_rows)
    got, want = (_cells(report.roofline_table(rows)),
                 _cells(ref_report.roofline_table(ref_rows)))
    assert [len(r) for r in got] == [len(r) for r in want]
    assert len(got) == 2 + 4 + 1    # header, rule, 4 ok cells, 1 skipped
    for g, w in zip(got, want):
        assert g[:-2] == w[:-2]
    hints = " ".join(r[-2] for r in got)
    assert "MXU" not in hints and "DESIGN.md" not in hints
    for x in (0, 3e-7, 2.5e-4, 0.5, 12.0):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return mesh_check.run(tmp_path_factory.mktemp("collectives"),
                          ["collectives"], WORLD)


def test_collective_bytes_counts_each_call_once_by_its_output(collectives):
    got = case(collectives, "collectives")
    want = mesh_check.collective_cases(WORLD)
    assert {k: v["bytes"] for k, v in got["each"].items()} == want
    # one data-moving call each (a gather's autograd wrapper and its wait
    # are not counted)
    assert all(sum(v["calls"].values()) == 1 for v in got["each"].values())
    assert got["total"] == sum(want.values())
