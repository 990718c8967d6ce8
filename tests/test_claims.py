"""Claims ledger: headline doc numbers must match their artifacts.

Guards the README/EXPERIMENTS tables against doc rot — every registered
headline number is re-derived from its committed artifact
(`kanodes/diag/claims.py`); the slow tier additionally reloads the
deliverable param files and recomputes the record MSEs from scratch.
"""

import pytest

from kanodes.diag import claims


def test_shallow_claims_verified():
    results = claims.check(deep=False)
    bad = [r for r in results if not r["ok"]]
    assert results and not bad, bad


def test_claims_cli_exit_code():
    assert claims.main([]) == 0


@pytest.mark.slow
def test_deep_claims_reproduce_from_params():
    """The deliverable-params doctrine, executable: reload each record's
    committed .npy, rebuild the model, recompute the headline MSEs."""
    results = claims.check(deep=True)
    deep = [r for r in results if r["name"].startswith("deep_")]
    bad = [r for r in results if not r["ok"]]
    assert len(deep) >= 3 and not bad, bad
