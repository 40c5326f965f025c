"""The port's examples (`repro_torch.examples.quickstart`,
`.dp_accounting`, `.secret_sharer_e2e`) run end to end on the CPU at a few
rounds: through the port's trainer (engine backend), accountant,
``generate`` and Secret Sharer. The accountant's walkthrough is held
against the reference's ``table5_epsilon``."""
import math

import numpy as np

from repro.core.accountant import table5_epsilon as j_table5
from repro_torch.examples import dp_accounting, quickstart, secret_sharer_e2e
# importing the autouse fixture `_one_thread` runs this file's tests on one
# torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401


def test_quickstart_trains_accounts_and_decodes_on_cpu():
    out = quickstart.main(["--device", "cpu", "--rounds", "4",
                           "--rounds-per-call", "2", "--n-users", "60",
                           "--clients-per-round", "10"])
    assert math.isfinite(out["loss"]) and out["loss"] < 1.5 * math.log(
        quickstart.VOCAB)
    assert out["rounds"] == 4 and out["eps"] > 0
    assert np.asarray(out["continuations"]).shape == (2, 3 + 5)


def test_dp_accounting_walkthrough_matches_the_reference():
    out = dp_accounting.main(["--rounds", "200"])
    for N, (wor, poi) in out["table5"].items():
        np.testing.assert_allclose(wor, j_table5(N, rounds=200,
                                                 sampling="wor"), rtol=1e-6)
        np.testing.assert_allclose(poi, j_table5(N, rounds=200,
                                                 sampling="poisson"),
                                   rtol=1e-6)
    z = list(out["z_sweep"].values())
    assert all(a > b for a, b in zip(z, z[1:]))   # more noise, smaller eps


def test_secret_sharer_e2e_trains_and_measures_on_cpu():
    out = secret_sharer_e2e.main(["--device", "cpu", "--rounds", "4",
                                  "--rounds-per-call", "2", "--n-users",
                                  "60", "--rs-samples", "500"])
    assert len(out["ranks"]) == len(secret_sharer_e2e.GRID)
    assert all(0 <= r <= 500 for r in out["ranks"])
    assert len(out["extracted"]) == len(secret_sharer_e2e.GRID)
