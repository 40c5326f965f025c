"""The plain references against the port's plain CPU path at reduced
widths, in float32: the CIFG-LSTM and Mamba-2 losses, the Secret Sharer's
scores, and whole DP-FedAvg rounds and RS passes through the drivers (the
draws worked out again must be the engine's)."""
import pytest
import torch

from port_bench.reference import lstm as RL
from port_bench.reference import ssm as RS
from port_bench.reference import tree as T
from port_bench.tests.tiny import SEED, run_check, tiny_cell

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _port(cell):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.registry import build
    return build(ModelConfig(**cell.config["model"]))


def _batch(vocab, B, S, g):
    rows = torch.randint(4, vocab, (B, S + 1), generator=g)
    rows[0, -3:] = 0                                    # some padding
    return rows[:, :-1], rows[:, 1:], (rows[:, 1:] != 0).float()


@pytest.mark.parametrize("name,ref", [("lstm-fedavg", RL),
                                      ("mamba2-fedavg", RS)])
def test_loss_and_gradient_match_the_port(name, ref):
    cell = tiny_cell(name)
    model = cell.config["model"]
    g = torch.Generator().manual_seed(3)
    params = ref.init(model, cell.workload["init"], g)
    tok, lab, msk = _batch(model["vocab"], 3, 64, g)
    port = _port(cell)
    p1 = T.tmap(lambda l: l.clone().requires_grad_(True), params)
    lp = port.loss_fn(p1, {"tokens": tok, "labels": lab, "mask": msk})
    gp = torch.autograd.grad(lp, T.leaves(p1))
    p2 = T.tmap(lambda l: l.clone()[None].requires_grad_(True), params)
    lr = ref.client_losses(p2, tok[None], lab[None], msk[None], model,
                           "float32")[0]
    gr = torch.autograd.grad(lr, T.leaves(p2))
    assert abs(float(lp) - float(lr)) <= 1e-5 * abs(float(lr))
    for a, b in zip(gp, gr):
        assert torch.allclose(a, b[0], rtol=1e-4,
                              atol=1e-5 * float(b.abs().max()))


def test_scores_match_the_port():
    from repro_torch.core.secret_sharer import score_canaries
    cell = tiny_cell("lstm-memorize")
    model = cell.config["model"]
    g = torch.Generator().manual_seed(4)
    params = RL.init(model, cell.workload["init"], g)
    seqs = torch.randint(0, model["vocab"], (40, 5), generator=g)
    ported = score_canaries(_port(cell), params, seqs)
    mine = RL.scores(params, seqs, 2, "float32")
    assert torch.allclose(ported, mine, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["lstm-fedavg", "mamba2-fedavg",
                                  "lstm-memorize"])
def test_a_run_is_correct_on_the_cpu(name):
    ok, checks = run_check(tiny_cell(name))
    assert ok, checks
    assert all(v < 1e-3 for v in checks.values()), checks


def test_flops_count():
    lstm = {"d_model": 96, "d_ff": 256, "vocab": 10000}
    assert RL.train_flops_per_token(lstm) == 6 * (96 * 768 + 256 * 768
                                                  + 256 * 96 + 96 * 10000)
    assert RL.score_flops_per_sequence(lstm, 5, 2) == pytest.approx(
        2 * (4 * (96 * 768 + 256 * 768) + 3 * (256 * 96 + 96 * 10000)))
    m2 = {"d_model": 1024, "n_layers": 48, "ssm_state": 128,
          "ssm_heads": 32, "ssm_expand": 2, "ssm_conv_width": 4,
          "vocab": 50280}
    assert 2.2e9 < RS.train_flops_per_token(m2, 512) < 2.6e9
    assert SEED > 2 ** 31
