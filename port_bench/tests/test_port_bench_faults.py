"""The check must come out false when the timed path is broken. Each test
skips the run's look for a card and drives the rest of a run on the CPU,
at a size the CPU holds (`tiny.tiny_cell`), with one fault planted in the
port underneath, and sees ``correct`` false: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, and an answer altered where it is produced (one cell has no
exchange between cards to leave out). The control, the reference in
float8 in the program's place, must come out false too."""
import numpy as np
import pytest
import torch

from port_bench.harness import compare as C
from port_bench.harness import manifest
from port_bench.tests.tiny import SEED, one_thread, run_check, tiny_cell

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _plant_fedavg(monkeypatch, fault):
    from repro_torch.fl import engine as E
    from repro_torch.utils.pytree import tree_map

    if fault == "state_unchanged":
        monkeypatch.setattr(E, "server_step",
                            lambda params, opt, delta, dp: (params, opt))
    elif fault == "half_batch":
        orig_sums, orig_init = E.stream_block_sums, E.SimEngine.__init__

        def half_sums(compute_chunk, inputs, masks, *a, **k):
            masks = masks.clone()
            masks.view(-1)[masks.numel() // 2:] = 0
            return orig_sums(compute_chunk, inputs, masks, *a, **k)

        def half_init(self, *a, **k):
            orig_init(self, *a, **k)
            self._round_denom = self.cohort // 2

        monkeypatch.setattr(E, "stream_block_sums", half_sums)
        monkeypatch.setattr(E.SimEngine, "__init__", half_init)
    else:
        orig = E.local_deltas

        def altered(model, params, batches, client):
            deltas, losses = orig(model, params, batches, client)
            deltas[0] = tree_map(torch.neg, deltas[0])
            return deltas, losses

        monkeypatch.setattr(E, "local_deltas", altered)


def _plant_memorize(monkeypatch, fault):
    from repro_torch.core import secret_sharer as ss
    orig = ss.random_sampling_ranks

    def broken(model, params, canaries, *a, continuations=None, **k):
        if fault == "state_unchanged":
            return np.zeros(len(canaries), np.int64)
        if fault == "half_batch":
            half = continuations[:continuations.shape[0] // 2]
            return orig(model, params, canaries, *a, continuations=half, **k)
        ranks = orig(model, params, canaries, *a,
                     continuations=continuations, **k)
        return ranks + continuations.shape[0] // 20

    monkeypatch.setattr(ss, "random_sampling_ranks", broken)


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["lstm-fedavg", "mamba2-fedavg"])
def test_fedavg_fault_is_caught(monkeypatch, name, fault):
    _plant_fedavg(monkeypatch, fault)
    ok, checks = run_check(tiny_cell(name))
    assert not ok, checks


@pytest.mark.parametrize("fault", FAULTS)
def test_memorize_fault_is_caught(monkeypatch, fault):
    _plant_memorize(monkeypatch, fault)
    ok, checks = run_check(tiny_cell("lstm-memorize"))
    assert not ok, checks


@pytest.mark.parametrize("name", ["lstm-fedavg", "mamba2-fedavg",
                                  "lstm-memorize"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name, compute_dtype="bfloat16")
    drv = manifest.driver(cell.workload)
    pick = ((0, list(range(cell.traffic["n_canaries"])))
            if "n_canaries" in cell.traffic else None)
    with one_thread():
        ref = drv.reference(cell, SEED, "cpu", pick=pick)
        ctl = drv.reference(cell, SEED, "cpu", prec="float8", pick=pick)
        checks = drv.compare(cell, drv.as_readings(ctl), ref)
    assert not C.judge(checks, cell.workload["limits"]), checks
