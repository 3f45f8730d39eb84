"""`_stage_prep` under the windowed weight ladder (what
LIGHTHOUSE_TPU_PALLAS=1 selects at import) against `_stage_prep` under
the bit ladder. The two ladders give one group element in other
projective coordinates, so the affine outputs are held canon-equal and
`flags_ok` equal; the ladders are called directly (monkeypatched into the
curve module), since the switch is read at import."""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as TB
from lighthouse_tpu_torch.crypto.bls.gpu import curve as C
from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L

from torch_port_util import both, make_signed, need_card

# 4 sets over 3 messages, one with two keys, one forged (the verdict is
# not prep's business; prep must agree either way)
SPEC = [((0,), 0, None), ((1, 2), 1, None), ((3,), 2, 0), ((4,), 0, None)]


def _prep(monkeypatch, ladder, mb):
    monkeypatch.setattr(C, "scalar_mul_u64", ladder)
    return TB._stage_prep(mb.pk, mb.sig, mb.scalars, mb.real)


def _same_group_elements(win, bit):
    rpk_w, rinf_w, ssum_w, sinf_w, ok_w = win
    rpk_b, rinf_b, ssum_b, sinf_b, ok_b = bit
    assert torch.equal(rinf_w, rinf_b) and torch.equal(sinf_w, sinf_b)
    assert torch.equal(ok_w, ok_b)
    assert torch.equal(L.canon(rpk_w), L.canon(rpk_b))
    assert torch.equal(L.canon(ssum_w), L.canon(ssum_b))


def test_windowed_prep_canon_equal_to_bit_prep(monkeypatch):
    _, tsets = both(make_signed(), SPEC)
    mb = TB._marshal_batch(tsets, "cpu", seed=21)
    mb.scalars[0] = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF])  # top bits set
    win = _prep(monkeypatch, C.scalar_mul_u64_windowed, mb)
    bit = _prep(monkeypatch, C._scalar_mul_u64_bit, mb)
    _same_group_elements(win, bit)
    assert bool(win[4]) and win[1].tolist() == [False] * 4
    # the windowed ladder's limbs differ from the bit ladder's (else this
    # test could not tell the ladders apart)
    assert not torch.equal(win[0], bit[0])


@pytest.mark.gpu
def test_windowed_prep_on_card_equals_its_cpu_limbs(monkeypatch):
    """On the card, through the kernels: the windowed prep's limbs equal
    its CPU limbs, and stay canon-equal to the bit ladder's."""
    dev = need_card()
    _, tsets = both(make_signed(), SPEC)
    mb = TB._marshal_batch(tsets, dev, seed=21)
    mb_cpu = TB._marshal_batch(tsets, "cpu", seed=21)
    win = _prep(monkeypatch, C.scalar_mul_u64_windowed, mb)
    win_cpu = _prep(monkeypatch, C.scalar_mul_u64_windowed, mb_cpu)
    for g, w in zip(win, win_cpu):
        assert torch.equal(g.cpu(), w)
    _same_group_elements(win, _prep(monkeypatch, C._scalar_mul_u64_bit, mb))
