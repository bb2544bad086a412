"""The port's copy of the analytic resource and Fmax model equals the
reference's, function by function, at the paper's configuration and at
variants of it."""
import dataclasses

import pytest

from repro.core import resources as jR
from repro.core.machine import SMConfig as JSMConfig
from repro_torch.core import SMConfig
from repro_torch.core import resources as R

_VARIANTS = [{}, {"shmem_depth": 512, "with_dot": False},
             {"shmem_depth": 1024, "imem_depth": 2048}]


def _plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_tables_equal_the_reference():
    assert {k: _plain(v) for k, v in R.table_v().items()} \
        == {k: _plain(v) for k, v in jR.table_v().items()}
    assert R.table_i() == jR.table_i()


@pytest.mark.parametrize("kw", _VARIANTS)
def test_sm_report_equals_the_reference(kw):
    assert _plain(R.sm_report(SMConfig(**kw))) \
        == _plain(jR.sm_report(JSMConfig(**kw)))


@pytest.mark.parametrize("sms", [1, 2, 4])
def test_sector_packing_and_peaks_equal_the_reference(sms):
    assert _plain(R.pack_sector(sms)) == _plain(jR.pack_sector(sms))
    assert R.fmax_mhz(sms) == jR.fmax_mhz(sms)
    assert R.fmax_mhz(sms, use_dsp_fp32=False) \
        == jR.fmax_mhz(sms, use_dsp_fp32=False)
    for with_dot in (True, False):
        assert R.peak_gflops(sms, with_dot=with_dot) \
            == jR.peak_gflops(sms, with_dot=with_dot)
    for depth in (64, 512, 3072):
        assert R.shared_memory_m20ks(depth) == jR.shared_memory_m20ks(depth)


def test_paper_numbers():
    assert R.fmax_mhz(1) == 771.0
    assert abs(R.fmax_mhz(4) - 738.0) < 1.0
    assert R.pack_sector(4).shared_depth_words == 3072
    assert (R.sp_report() + R.int_alu_report()).alms == 267 + 114
    assert R.instruction_report().scale(2).m20ks == 4
