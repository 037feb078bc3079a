"""The port's Figures 12 (speedup against the number of jobs) and 13 (the
tier count V) against the reference's ``benchmarks/``, at the reduced
sizing of ``test_torch_paper_tables.py``: seed 1 and a 3-day horizon, each
figure's own job counts (15, 30 and 60; 24).  Returned dicts equal exactly,
printed output equal with ``us_per_call`` masked.
"""
import pytest

from test_torch_paper_figs import _names
from test_torch_paper_tables import both


@pytest.mark.parametrize("name", ["fig12_numjobs", "fig13_tiers"])
def test_figure_equals_reference(name, capsys, monkeypatch):
    want, want_out, got, got_out = both(name, capsys, monkeypatch)
    assert got == want
    assert got_out == want_out
    assert _names(got_out)[-1] == name.split("_")[0] + "_validates"
