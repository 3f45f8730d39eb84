"""The port's validator store (lighthouse_tpu_torch/validator_client/
{slashing_protection,validator_store,byzantine}.py) against the JAX
package's on the CPU, exact equality throughout:

- `SlashingDatabase`: the same decision (signed, or the NotSafe text) for
  every step of a seeded sequence of block proposals and attestations
  over several validators, the same EIP-3076 interchange out, and a
  database that imports it makes the same decisions after;
- `ValidatorStore`: the same signature bytes for every signing kind
  (block, attestation, randao, selection proof, aggregate and proof,
  sync-committee message, sync selection proof, contribution and proof,
  builder registration) over the same state; a doppelganger hold
  refuses before the database is touched;
- `ByzantineValidatorStore`: the same overrides (kind, slot or target,
  reason) and the same bytes for what it signs anyway; `ByzRoster`,
  `ByzPlan` and `PlaceholderKeystore` as in JAX.

The JAX side takes its interop public keys from the port's bytes
(`jax_keys_from_port`); secret keys and signatures are each package's
own. No XLA compile."""

import numpy as np
import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu import validator_client as JV
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch import validator_client as TV
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.types import containers as TC
from torch_port_util import carry_state, jax_keys_from_port, no_xla_compile

GVR = b"\x77" * 32


def _decisions(V, seed, db=None, pks=None):
    """A seeded run of proposals and attestations: [(op, args, outcome)],
    the outcome "ok" or the NotSafe text."""
    rng = np.random.default_rng(seed)
    pks = pks or [f"{i:02x}" * 48 for i in range(4)]
    if db is None:
        db = V.SlashingDatabase()
        for pk in pks[:3]:  # the last stays unregistered
            db.register_validator(pk)
    out = []
    for _ in range(120):
        pk = pks[int(rng.integers(len(pks)))]
        root = bytes([int(rng.integers(1, 4))]) * 32
        if rng.integers(3) == 0:
            args = (pk, int(rng.integers(0, 40)), root)
            fn = db.check_and_insert_block_proposal
        else:
            s = int(rng.integers(0, 12))
            args = (pk, s, s + int(rng.integers(0, 5)), root)
            fn = db.check_and_insert_attestation
        try:
            fn(*args)
            outcome = "ok"
        except V.NotSafe as e:
            outcome = str(e)
        out.append((fn.__name__, args, outcome))
    return db, out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slashing_database_decisions_and_interchange(seed):
    jdb, jout = _decisions(JV, seed)
    tdb, tout = _decisions(TV, seed)
    assert tout == jout
    assert sum(o == "ok" for _, _, o in tout) >= 10
    assert sum(o != "ok" for _, _, o in tout) >= 10
    payload = tdb.export_json(GVR)
    assert payload == jdb.export_json(GVR)
    again = []
    for V in (JV, TV):
        db = V.SlashingDatabase()
        db.import_json(payload, GVR)
        again.append(_decisions(V, seed + 10, db=db)[1])
    assert again[0] == again[1]
    with pytest.raises(TV.NotSafe):
        TV.SlashingDatabase().import_json(payload, b"\x78" * 32)


@pytest.fixture(scope="module")
def states():
    """A MINIMAL altair interop genesis of 16 validators in both packages
    (the JAX one carried from the port's bytes) at slot 9."""
    mp = pytest.MonkeyPatch()
    jax_keys_from_port(mp)
    try:
        from lighthouse_tpu_torch.state_transition import per_slot

        spec = T.ChainSpec.interop(altair_fork_epoch=0)
        state = per_slot.process_slots(T.interop_genesis_state(16, T.MINIMAL, spec), 9,
                                       T.MINIMAL, spec)
        jstate = carry_state(state, J.MINIMAL)
        yield state, jstate
    finally:
        mp.undo()


def _sign_all(P, C, V, api, state, spec):
    """Every signing kind of a ValidatorStore over validator 3's key, as
    bytes."""
    t = P.types_for(P.MINIMAL)
    store = V.ValidatorStore(P.MINIMAL, spec)
    key = V.LocalKeystore(api.SecretKey(0x1234567))
    pk = key.pubkey.to_bytes()
    store.add_validator(key, validator_index=3)
    data = C.AttestationData(slot=8, index=0, beacon_block_root=b"\x01" * 32,
                             source=C.Checkpoint(epoch=0, root=b"\x02" * 32),
                             target=C.Checkpoint(epoch=1, root=b"\x03" * 32))
    block = t.BeaconBlockAltair(slot=9, proposer_index=3, parent_root=b"\x04" * 32,
                                state_root=b"\x05" * 32, body=t.BeaconBlockBodyAltair.default())
    msg = t.AggregateAndProof(aggregator_index=3, selection_proof=b"\x06" * 96,
                              aggregate=t.Attestation(aggregation_bits=(True,), data=data,
                                                      signature=b"\x07" * 96))
    contribution = t.ContributionAndProof(
        aggregator_index=3, selection_proof=b"\x08" * 96,
        contribution=t.SyncCommitteeContribution.default())
    sigs = [
        store.sign_block(pk, block, state),
        store.sign_attestation(pk, data, state),
        store.sign_randao(pk, 1, state),
        store.sign_selection_proof(pk, 9, state),
        store.sign_aggregate_and_proof(pk, msg, state),
        store.sign_sync_committee_message(pk, 9, b"\x09" * 32, state),
        store.sign_sync_selection_proof(pk, 9, 2, state),
        store.sign_contribution_and_proof(pk, contribution, state),
    ]
    registration = store.sign_validator_registration(pk, b"\x0a" * 20, 30_000_000, 1700)
    return [s.to_bytes() for s in sigs] + [registration.as_ssz_bytes()]


def test_validator_store_signature_bytes(states):
    state, jstate = states
    with no_xla_compile():
        tsigs = _sign_all(T, TC, TV, tapi, state, T.ChainSpec.interop(altair_fork_epoch=0))
        jsigs = _sign_all(J, JC, JV, japi, jstate, J.ChainSpec.interop(altair_fork_epoch=0))
    assert tsigs == jsigs
    assert len(set(tsigs)) == len(tsigs)


@pytest.mark.parametrize("V, api", [(JV, japi), (TV, tapi)], ids=["jax", "port"])
def test_doppelganger_hold_refuses_before_the_database(states, V, api):
    state = states[1] if V is JV else states[0]
    P = J if V is JV else T
    C = JC if V is JV else TC
    store = V.ValidatorStore(P.MINIMAL, P.ChainSpec.interop(altair_fork_epoch=0))
    key = V.LocalKeystore(api.SecretKey(99))
    pk = key.pubkey.to_bytes()
    store.add_validator(key, validator_index=1, doppelganger_protection=True)
    data = C.AttestationData(slot=8, index=0, beacon_block_root=b"\x01" * 32,
                             source=C.Checkpoint(epoch=0, root=bytes(32)),
                             target=C.Checkpoint(epoch=1, root=bytes(32)))
    with pytest.raises(V.DoppelgangerHold):
        store.sign_attestation(pk, data, state)
    store.release_doppelganger(pk)
    store.sign_attestation(pk, data, state)  # not burned by the held attempt
    with pytest.raises(KeyError):
        store.sign_randao(b"\x00" * 48, 1, state)


def _byzantine(P, C, V, api, state, spec):
    """A ByzantineValidatorStore through double proposals, double votes and
    a surround, over a placeholder key and a real one: its overrides and
    the bytes of every signature it returned."""
    t = P.types_for(P.MINIMAL)
    plan = V.ByzPlan(fraction=0.5, every=1, surround_votes=True)
    roster = V.ByzRoster(plan, P.MINIMAL, spec)
    roster.enroll(5, b"\xaa" * 48)
    store = roster.store
    real = V.LocalKeystore(api.SecretKey(4242))
    store.add_validator(real, validator_index=6)
    out = []
    for pk in (b"\xaa" * 48, real.pubkey.to_bytes()):
        for graffiti in (1, 2):
            body = t.BeaconBlockBodyAltair.default()
            body.graffiti = bytes([graffiti]) * 32
            block = t.BeaconBlockAltair(slot=9, proposer_index=5, parent_root=bytes(32),
                                        state_root=bytes(32), body=body)
            out.append(store.sign_block(pk, block, state).to_bytes())
        for s, tgt, root in ((1, 2, 1), (1, 2, 2), (0, 3, 1), (1, 2, 1)):
            data = C.AttestationData(
                slot=8, index=0, beacon_block_root=bytes([root]) * 32,
                source=C.Checkpoint(epoch=s, root=bytes(32)),
                target=C.Checkpoint(epoch=tgt, root=bytes(32)))
            out.append(store.sign_attestation(pk, data, state).to_bytes())
    return (out, list(store.overrides), plan.active(), V.ByzPlan(fraction=0).active(),
            5 in roster, 6 in roster, len(roster), roster.pubkey_of(5))


def test_byzantine_store_overrides_and_signatures(states):
    state, jstate = states
    with no_xla_compile():
        tout = _byzantine(T, TC, TV, tapi, state, T.ChainSpec.interop(altair_fork_epoch=0))
        jout = _byzantine(J, JC, JV, japi, jstate, J.ChainSpec.interop(altair_fork_epoch=0))
    assert tout == jout
    sigs, overrides = tout[0], tout[1]
    assert [k for k, _, _ in overrides] == ["block", "attestation", "attestation"] * 2
    assert sigs[:6] == [tapi.INFINITY_SIGNATURE] * 6  # the placeholder key signs nothing
    assert tout[2:] == (True, False, True, False, 1, b"\xaa" * 48)
    # the honest store refuses the same sequence
    honest = TV.ValidatorStore(T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0))
    key = TV.LocalKeystore(tapi.SecretKey(4242))
    honest.add_validator(key, validator_index=6)
    t = T.types_for(T.MINIMAL)
    refused = 0
    for graffiti in (1, 2):
        body = t.BeaconBlockBodyAltair.default()
        body.graffiti = bytes([graffiti]) * 32
        block = t.BeaconBlockAltair(slot=9, proposer_index=6, parent_root=bytes(32),
                                    state_root=bytes(32), body=body)
        try:
            honest.sign_block(key.pubkey.to_bytes(), block, state)
        except TV.NotSafe:
            refused += 1
    assert refused == 1
