"""The port's slasher (lighthouse_tpu_torch/slasher/{slasher,service}.py)
against the JAX package's on the CPU: the same seeded stream of indexed
attestations and block headers through both packages' `Slasher`, in the
same batches, emits the same attester and proposer slashings, byte for
byte in SSZ: double votes, surrounding and surrounded votes, double
proposals, innocent validators untouched. Then both slashers are closed
and reopened over their key-value stores (`Slasher.open`), and the
detections that need the stored records are again equal; the stores
hold the same keys and values. The service pools and broadcasts what it
finds, in the same order. The min/max-target planes are numpy tiles on
the host in both packages, so nothing here touches a device."""

import numpy as np
import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.slasher import Slasher as JSlasher
from lighthouse_tpu.slasher import SlasherService as JService
from lighthouse_tpu.store.kv import MemoryStore as JMemoryStore
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.slasher import Slasher as TSlasher
from lighthouse_tpu_torch.slasher import SlasherService as TService
from lighthouse_tpu_torch.store.kv import MemoryStore as TMemoryStore
from lighthouse_tpu_torch.types import containers as TC

HISTORY = 64


def _indexed(P, C, validators, source, target, root):
    t = P.types_for(P.MINIMAL)
    return t.IndexedAttestation(
        attesting_indices=tuple(sorted(validators)),
        data=C.AttestationData(
            slot=target * P.MINIMAL.slots_per_epoch, index=0,
            beacon_block_root=bytes([root]) * 32,
            source=C.Checkpoint(epoch=source, root=bytes(32)),
            target=C.Checkpoint(epoch=target, root=bytes(32))),
        signature=bytes([root]) * 96)


def _header(C, proposer, slot, graffiti):
    return C.SignedBeaconBlockHeader(
        message=C.BeaconBlockHeader(slot=slot, proposer_index=proposer,
                                    parent_root=bytes([graffiti]) * 32,
                                    state_root=bytes(32), body_root=bytes(32)),
        signature=bytes([graffiti]) * 96)


def _stream(seed, n=40):
    """Batches of ('att', validators, source, target, root) and
    ('blk', proposer, slot, graffiti) with double votes, surrounds both
    ways and double proposals planted among honest traffic."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(4):
        batch = []
        for _ in range(n // 4):
            vs = sorted(set(int(v) for v in rng.integers(0, 24, int(rng.integers(1, 5)))))
            s = int(rng.integers(0, 20))
            batch.append(("att", vs, s, s + int(rng.integers(1, 6)), int(rng.integers(1, 4))))
            if rng.integers(3) == 0:
                batch.append(("blk", int(rng.integers(0, 8)), int(rng.integers(1, 12)),
                              int(rng.integers(1, 3))))
        batches.append(batch)
    # planted: a double vote, a surrounding vote, a surrounded vote, a
    # double proposal (each against an earlier batch's record)
    batches[1] += [("att", [30], 5, 8, 1)]
    batches[2] += [("att", [30], 6, 8, 2), ("att", [31], 4, 9, 1), ("blk", 9, 3, 1)]
    batches[0] += [("att", [31], 5, 7, 1), ("att", [32], 2, 10, 1)]
    batches[3] += [("att", [32], 3, 6, 1), ("blk", 9, 3, 2)]
    return batches


def _feed(P, C, slasher, batch):
    for item in batch:
        if item[0] == "att":
            slasher.accept_attestation(_indexed(P, C, *item[1:]))
        else:
            slasher.accept_block_header(_header(C, *item[1:]))
    atts, props = slasher.process_queued()
    return [s.as_ssz_bytes() for s in atts], [s.as_ssz_bytes() for s in props]


def _store_items(kv):
    return sorted((bytes(c), bytes(k), bytes(v)) for c, col in kv._data.items()
                  for k, v in col.items())


@pytest.mark.parametrize("seed", [0, 1])
def test_slashings_equal_across_packages_and_a_restart(seed):
    batches = _stream(seed)
    out = []
    for P, C, S, KV in ((J, JC, JSlasher, JMemoryStore), (T, TC, TSlasher, TMemoryStore)):
        kv = KV()
        slasher = S.open(kv, P.MINIMAL, P.ChainSpec.interop(), history_epochs=HISTORY)
        got = [_feed(P, C, slasher, b) for b in batches[:2]]
        # a restart: a new slasher over the same store finds what needs the
        # records of the first one's batches
        slasher = S.open(kv, P.MINIMAL, P.ChainSpec.interop(), history_epochs=HISTORY)
        got += [_feed(P, C, slasher, b) for b in batches[2:]]
        out.append((got, _store_items(kv)))
    (jgot, jstore), (tgot, tstore) = out
    assert tgot == jgot
    assert tstore == jstore
    atts = [s for batch_atts, _ in tgot for s in batch_atts]
    props = [s for _, batch_props in tgot for s in batch_props]
    assert len(atts) >= 4 and len(props) >= 1
    t = T.types_for(T.MINIMAL)
    from lighthouse_tpu_torch.state_transition.per_block import is_slashable_attestation_data

    for raw in atts:
        s = t.AttesterSlashing.from_ssz_bytes(raw)
        assert is_slashable_attestation_data(s.attestation_1.data, s.attestation_2.data)
    planted = {tuple(sorted(set(t.AttesterSlashing.from_ssz_bytes(raw).attestation_1
                                .attesting_indices) &
                            set(t.AttesterSlashing.from_ssz_bytes(raw).attestation_2
                                .attesting_indices))) for raw in atts}
    assert {(30,), (31,), (32,)} <= planted


def test_service_pools_and_broadcasts_in_the_same_order():
    """SlasherService over each package's slasher: accept_attestation and
    accept_block (a block reduced to its header), one update; the op pool
    and the broadcast see the same slashings in the same order."""
    out = []
    for P, C, S, Svc in ((J, JC, JSlasher, JService), (T, TC, TSlasher, TService)):
        pool, sent = [], []

        class Pool:
            def insert_attester_slashing(self, s):
                pool.append(("att", s.as_ssz_bytes()))

            def insert_proposer_slashing(self, s):
                pool.append(("prop", s.as_ssz_bytes()))

        t = P.types_for(P.MINIMAL)
        svc = Svc(S(P.MINIMAL, P.ChainSpec.interop(), history_epochs=HISTORY), Pool(),
                  broadcast=lambda kind, op: sent.append((kind, op.as_ssz_bytes())))
        for v, s, tgt, root in ((3, 1, 2, 1), (3, 1, 2, 2), (4, 2, 5, 1), (4, 3, 4, 1)):
            svc.accept_attestation(_indexed(P, C, [v], s, tgt, root))
        for graffiti in (1, 2):
            body = t.BeaconBlockBody.default()
            body.graffiti = bytes([graffiti]) * 32
            block = t.BeaconBlock(slot=5, proposer_index=6, parent_root=bytes(32),
                                  state_root=bytes(32), body=body)
            svc.accept_block(t.SignedBeaconBlock(message=block, signature=bytes(96)))
        new_att, new_prop = svc.update()
        out.append((pool, sent, len(new_att), len(new_prop), svc.attestations_seen,
                    svc.blocks_seen, svc.attester_slashings_found,
                    svc.proposer_slashings_found))
    assert out[0] == out[1]
    assert out[1][2:] == (2, 1, 4, 2, 2, 1)
