"""Genesis from eth1 deposits through the port's `torch_cuda` backend
(lighthouse_tpu_torch/state_transition/genesis.py over the batch
verifier): two deposits, the second one's signature forged, give the
same per-deposit verdicts and the same state as on the port's `cpu`
backend -- on CPU tensors here (`device="cpu"`, each one-set call ~8 s of
plain stages), and on the card in the `gpu` twin."""

import importlib.util
from pathlib import Path

import pytest

from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.state_transition import genesis as TG
from lighthouse_tpu_torch.state_transition import per_block as TPB
from torch_port_util import need_card

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


@pytest.fixture(autouse=True)
def _backend():
    saved = (tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    yield
    tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE = saved


def _genesis_verdicts(monkeypatch, backend, device=None):
    """(per-deposit verdicts, state) of a genesis of two deposits, the
    second forged, on `backend`."""
    C = CS.consensus_modules()
    spec = T.ChainSpec.minimal()
    datas = CS.genesis_deposit_data(C, spec, 2, CS.HostCrypto(), forged=(1,))
    deposits = CS.deposit_list(C, datas)[1]
    verdicts, real = [], tapi.verify_signature_sets

    def spy(sets, *args, **kwargs):
        verdicts.append(real(sets, *args, **kwargs))
        return verdicts[-1]

    monkeypatch.setattr(TPB, "verify_signature_sets", spy)
    tapi.set_backend(backend, device=device)
    state = TG.initialize_beacon_state_from_eth1(
        CS.ETH1_BLOCK_HASH, spec.min_genesis_time, deposits, T.MINIMAL, spec)
    return verdicts, state


def _check(monkeypatch, device):
    got, state = _genesis_verdicts(monkeypatch, "torch_cuda", device)
    want, want_state = _genesis_verdicts(monkeypatch, "cpu")
    assert got == want == [True, False]
    assert state.as_ssz_bytes() == want_state.as_ssz_bytes()
    assert len(state.validators) == 1


def test_torch_cuda_on_cpu_gives_the_cpu_backend_verdicts(monkeypatch):
    _check(monkeypatch, "cpu")


@pytest.mark.gpu
def test_torch_cuda_on_the_card_gives_the_cpu_backend_verdicts(monkeypatch):
    need_card()
    _check(monkeypatch, None)
