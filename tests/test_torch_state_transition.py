"""The port's epoch, slot and block processing
(lighthouse_tpu_torch/state_transition/{per_epoch,per_epoch_vec,
participation,upgrades,per_slot,per_block}.py) against the JAX package's
on the CPU, byte for byte on the states:

- `process_epoch` on the same pre-states, phase0 and altair, on the
  vector path and under LIGHTHOUSE_TPU_EPOCH_ORACLE=1; the pre-states are
  epoch ends of a MINIMAL chain that the JAX harness builds with full
  participation for two epochs and half after (rewards, penalties and,
  at the last boundary, the inactivity leak all at work);
- `process_slots` across epoch boundaries and across the altair upgrade
  (altair at epoch 1); LIGHTHOUSE_TPU_EPOCH_MESH=1 raises
  NotImplementedError naming ROADMAP item 13 before touching the state;
- `per_block_processing` on every block of those chains, and on blocks
  with a proposer slashing, an attester slashing, a voluntary exit and a
  deposit; rejected blocks raise the same BlockProcessingError text.

States and blocks cross the packages as SSZ bytes (`carry_state`,
`carry_block`); the JAX side takes its public keys from the port's bytes
(`jax_keys_from_port`) and both packages run the `fake` backend. No XLA
compile."""

import dataclasses

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu.crypto.bls import INFINITY_SIGNATURE
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.eth1.deposit_tree import DepositDataTree
from lighthouse_tpu.harness.chain import StateHarness
from lighthouse_tpu.ssz import cached_root as jax_cached_root
from lighthouse_tpu.state_transition import per_block as JPB
from lighthouse_tpu.state_transition import per_epoch as JPE
from lighthouse_tpu.state_transition import per_slot as JPS
from lighthouse_tpu.state_transition.context import BlockProcessingError as JBPE
from lighthouse_tpu.types import containers as JC
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.state_transition import per_block as TPB
from lighthouse_tpu_torch.state_transition import per_epoch as TPE
from lighthouse_tpu_torch.state_transition import per_slot as TPS
from lighthouse_tpu_torch.state_transition.context import BlockProcessingError as TBPE
from torch_port_util import carry_block, carry_state, jax_keys_from_port, no_xla_compile

N_VALIDATORS = 64
SPE = J.MINIMAL.slots_per_epoch
FULL_EPOCHS = 2  # full participation, then half the registry attests
EPOCHS = 7
HALF = frozenset(range(N_VALIDATORS // 2))
ALTAIR_AT = {"phase0": None, "altair": 0}


def _specs(fork, **over):
    """(jax spec, port spec) of the same values."""
    js = J.ChainSpec.interop(altair_fork_epoch=ALTAIR_AT.get(fork, fork))
    ts = T.ChainSpec.interop(altair_fork_epoch=ALTAIR_AT.get(fork, fork))
    return dataclasses.replace(js, **over), dataclasses.replace(ts, **over)


@pytest.fixture(autouse=True)
def _backends(monkeypatch):
    jax_keys_from_port(monkeypatch)
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


def _extend(h, slot, participants=None):
    """Produce and apply the block at `slot` on the harness head with the
    attestations of slot - 1; returns (pre-state, block, post-state)."""
    pre = JPS.clone_state(h.state)
    atts = []
    if slot > 1:
        adv = JPS.process_slots(JPS.clone_state(h.state), slot, h.preset, h.spec)
        atts = h.attestations_for_slot(adv, slot - 1, validators=participants)
    signed, _ = h.produce_block(slot, atts)
    h.apply_block(signed, strategy=JPB.BlockSignatureStrategy.NO_VERIFICATION)
    return pre, signed, JPS.clone_state(h.state)


@pytest.fixture(scope="module")
def chains():
    """{fork: [(pre-state, block, post-state)]} of a JAX harness chain of
    EPOCHS epochs at MINIMAL: every validator attests for FULL_EPOCHS
    epochs, then only HALF of them (so justification stalls and the
    inactivity leak starts)."""
    saved = (japi._BACKEND, japi._BACKEND_NAME)
    out = {}
    with pytest.MonkeyPatch.context() as mp, no_xla_compile():
        jax_keys_from_port(mp)
        japi.set_backend("fake")
        try:
            for fork in ("phase0", "altair"):
                h = StateHarness(N_VALIDATORS, J.MINIMAL, _specs(fork)[0], sign=False)
                out[fork] = [
                    _extend(h, slot, None if slot <= FULL_EPOCHS * SPE else HALF)
                    for slot in range(1, EPOCHS * SPE)]
        finally:
            japi._BACKEND, japi._BACKEND_NAME = saved
    return out


def _epoch_end(chains, fork, epoch):
    """The JAX state after the block at the last slot of `epoch`."""
    post = chains[fork][(epoch + 1) * SPE - 2][2]
    assert post.slot == (epoch + 1) * SPE - 1
    return post


@pytest.mark.parametrize("oracle", [False, True], ids=["vector", "oracle"])
@pytest.mark.parametrize("epoch", [1, 3, EPOCHS - 1])
@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_process_epoch_equals_jax(chains, fork, epoch, oracle, monkeypatch):
    if oracle:
        monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_ORACLE", "1")
    else:
        monkeypatch.delenv("LIGHTHOUSE_TPU_EPOCH_ORACLE", raising=False)
    jspec, tspec = _specs(fork)
    js = JPS.clone_state(_epoch_end(chains, fork, epoch))
    ts = carry_state(js, J.MINIMAL)
    before = list(js.balances)
    JPE.process_epoch(js, J.MINIMAL, jspec)
    TPE.process_epoch(ts, T.MINIMAL, tspec)
    assert ts.as_ssz_bytes() == js.as_ssz_bytes()
    # the pre-state is one where penalties move balances, and rewards do
    # but in altair's leak (which pays no source or target reward)
    after = list(js.balances)
    leak = JPE._is_in_inactivity_leak(js, J.MINIMAL, jspec)
    assert leak == (epoch == EPOCHS - 1)
    assert TPE._is_in_inactivity_leak(ts, T.MINIMAL, tspec) == leak
    assert any(a < b for a, b in zip(after, before))
    assert any(a > b for a, b in zip(after, before)) != (fork == "altair" and leak)
    if fork == "altair" and leak:
        assert any(ts.inactivity_scores)


@pytest.mark.parametrize("fork", ["phase0", "altair"])
def test_per_block_processing_on_the_harness_blocks_equals_jax(chains, fork):
    """Every block of the chain, on its carried pre-state: slot processing
    (epoch transitions included) and the block give the JAX post-state."""
    _, tspec = _specs(fork)
    for pre, block, post in chains[fork]:
        ts = TPS.process_slots(carry_state(pre, J.MINIMAL), block.message.slot,
                               T.MINIMAL, tspec)
        TPB.per_block_processing(
            ts, carry_block(block, J.MINIMAL), T.MINIMAL, tspec,
            strategy=TPB.BlockSignatureStrategy.NO_VERIFICATION)
        assert ts.as_ssz_bytes() == post.as_ssz_bytes(), block.message.slot


def test_process_slots_across_the_altair_upgrade_equals_jax():
    """A phase0 chain with attestations at slots 1-7, then process_slots
    across the upgrade at epoch 1 (pending attestations translated into
    participation flags) and on across the next boundary."""
    jspec, tspec = _specs(1)
    h = StateHarness(N_VALIDATORS, J.MINIMAL, jspec, sign=False)
    for slot in range(1, SPE):
        _extend(h, slot)
    js = h.state
    assert js.fork_name == "phase0" and js.previous_epoch_attestations == ()
    assert js.current_epoch_attestations
    ts = carry_state(js, J.MINIMAL)
    for target in (SPE, SPE + 1, 2 * SPE + 1):
        js = JPS.process_slots(js, target, J.MINIMAL, jspec)
        ts = TPS.process_slots(ts, target, T.MINIMAL, tspec)
        assert ts.fork_name == js.fork_name == "altair"
        assert ts.as_ssz_bytes() == js.as_ssz_bytes()
        if target == SPE:
            assert any(ts.previous_epoch_participation)


def test_epoch_mesh_switch_raises_before_touching_the_state(chains, monkeypatch):
    """process_epoch refuses the switch with the state untouched, and so
    process_slots refuses to cross the boundary."""
    monkeypatch.setenv("LIGHTHOUSE_TPU_EPOCH_MESH", "1")
    _, tspec = _specs("altair")
    ts = carry_state(_epoch_end(chains, "altair", 1), J.MINIMAL)
    before = ts.as_ssz_bytes()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        TPE.process_epoch(ts, T.MINIMAL, tspec)
    assert ts.as_ssz_bytes() == before
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        TPS.process_slots(ts, ts.slot + 1, T.MINIMAL, tspec)


# --- blocks with operations ---------------------------------------------------


def _header(proposer, slot, parent_byte):
    return JC.SignedBeaconBlockHeader(
        message=JC.BeaconBlockHeader(
            slot=slot, proposer_index=proposer, parent_root=bytes([parent_byte]) * 32,
            state_root=bytes(32), body_root=bytes(32)),
        signature=INFINITY_SIGNATURE)


def _indexed(t, indices, root_byte, target_epoch=1):
    data = JC.AttestationData(
        slot=target_epoch * SPE, index=0, beacon_block_root=bytes([root_byte]) * 32,
        source=JC.Checkpoint(epoch=0, root=bytes(32)),
        target=JC.Checkpoint(epoch=target_epoch, root=bytes(32)))
    return t.IndexedAttestation(attesting_indices=tuple(indices), data=data,
                                signature=INFINITY_SIGNATURE)


def _deposit(state):
    """A deposit of a new validator (interop key 64) with its proof against
    a deposit tree of the registry's 64 leaves and it; returns the deposit
    and the eth1_data that the pre-state must carry."""
    from lighthouse_tpu.types import interop as JI

    sk, pk = JI.interop_keypair(N_VALIDATORS)
    creds = b"\x00" + bytes(31)
    amount = 32 * 10**9
    msg = JC.DepositMessage(pubkey=pk.to_bytes(), withdrawal_credentials=creds,
                            amount=amount)
    domain = J.compute_domain(J.DOMAIN_DEPOSIT, J.ChainSpec.interop().genesis_fork_version,
                              bytes(32))
    data = JC.DepositData(pubkey=pk.to_bytes(), withdrawal_credentials=creds,
                          amount=amount,
                          signature=sk.sign(J.compute_signing_root(msg, domain)).to_bytes())
    tree = DepositDataTree()
    for v in state.validators:
        tree.push(JC.DepositData(pubkey=bytes(v.pubkey), withdrawal_credentials=creds,
                                 amount=amount, signature=INFINITY_SIGNATURE))
    tree.push(data)
    count = len(state.validators) + 1
    eth1 = JC.Eth1Data(deposit_root=tree.root(count), deposit_count=count,
                       block_hash=bytes(state.eth1_data.block_hash))
    return tree.deposit(len(state.validators), data, count), eth1


def _operation_block(fork, op):
    """(jax pre-state, signed block, spec pair) of a block at the start of
    epoch 2 carrying one operation of kind `op`, its state root computed
    on a scratch state as the harness does. shard_committee_period is 1,
    so the genesis validators may exit."""
    jspec, tspec = _specs(fork, shard_committee_period=1)
    h = StateHarness(N_VALIDATORS, J.MINIMAL, jspec, sign=False)
    h.state = JPS.process_slots(h.state, 2 * SPE - 1, J.MINIMAL, jspec)
    t = J.types_for(J.MINIMAL)
    slot = h.state.slot + 1
    signed, _ = h.produce_block(slot)
    if op == "deposit":
        deposit, eth1 = _deposit(h.state)
        h.state.eth1_data = eth1
    body = signed.message.body
    if op == "proposer_slashing":
        body.proposer_slashings = (JC.ProposerSlashing(
            signed_header_1=_header(5, 3, 1), signed_header_2=_header(5, 3, 2)),)
    elif op == "attester_slashing":
        body.attester_slashings = (t.AttesterSlashing(
            attestation_1=_indexed(t, (2, 7, 9), 1),
            attestation_2=_indexed(t, (7, 9, 11), 2)),)
    elif op == "voluntary_exit":
        body.voluntary_exits = (JC.SignedVoluntaryExit(
            message=JC.VoluntaryExit(epoch=1, validator_index=3),
            signature=INFINITY_SIGNATURE),)
    elif op == "deposit":
        body.deposits = (deposit,)
    scratch = JPS.process_slots(JPS.clone_state(h.state), slot, J.MINIMAL, jspec)
    JPB.per_block_processing(scratch, signed, J.MINIMAL, jspec,
                             strategy=JPB.BlockSignatureStrategy.NO_VERIFICATION)
    signed.message.state_root = jax_cached_root(scratch)
    return h.state, signed, (jspec, tspec)


def _apply_both(pre, signed, specs):
    """The block on both packages; each side's post-state, or the text of
    the BlockProcessingError it raised."""
    jspec, tspec = specs
    js = JPS.process_slots(JPS.clone_state(pre), signed.message.slot, J.MINIMAL, jspec)
    ts = TPS.process_slots(carry_state(pre, J.MINIMAL), signed.message.slot,
                           T.MINIMAL, tspec)
    out = []
    for mod, state, block, preset, spec, err in (
            (JPB, js, signed, J.MINIMAL, jspec, JBPE),
            (TPB, ts, carry_block(signed, J.MINIMAL), T.MINIMAL, tspec, TBPE)):
        try:
            mod.per_block_processing(
                state, block, preset, spec,
                strategy=mod.BlockSignatureStrategy.NO_VERIFICATION)
            out.append(state)
        except err as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


@pytest.mark.parametrize("fork", ["phase0", "altair"])
@pytest.mark.parametrize(
    "op", ["proposer_slashing", "attester_slashing", "voluntary_exit", "deposit"])
def test_block_with_an_operation_equals_jax(fork, op):
    pre, signed, specs = _operation_block(fork, op)
    jpost, tpost = _apply_both(pre, signed, specs)
    assert not isinstance(jpost, str), jpost
    assert tpost.as_ssz_bytes() == jpost.as_ssz_bytes()
    if op == "proposer_slashing":
        assert tpost.validators[5].slashed
    elif op == "attester_slashing":
        assert tpost.validators[7].slashed and tpost.validators[9].slashed
    elif op == "voluntary_exit":
        assert tpost.validators[3].exit_epoch != T.FAR_FUTURE_EPOCH
    else:
        assert len(tpost.validators) == N_VALIDATORS + 1


def _reject(case):
    def mutate(body, state):
        if case == "identical_headers":
            hdr = _header(5, 3, 1)
            body.proposer_slashings = (JC.ProposerSlashing(
                signed_header_1=hdr, signed_header_2=hdr),)
        elif case == "not_slashable":
            t = J.types_for(J.MINIMAL)
            a = _indexed(t, (2, 7), 1)
            body.attester_slashings = (t.AttesterSlashing(attestation_1=a,
                                                          attestation_2=a),)
        elif case == "exit_from_the_future":
            body.voluntary_exits = (JC.SignedVoluntaryExit(
                message=JC.VoluntaryExit(epoch=99, validator_index=3),
                signature=INFINITY_SIGNATURE),)
        elif case == "deposit_count":
            body.deposits = (_deposit(state)[0],)
        elif case == "attestation_target":
            att = body.attestations[0]
            att.data.target = JC.Checkpoint(epoch=5, root=bytes(att.data.target.root))
    return mutate


@pytest.mark.parametrize("case", ["identical_headers", "not_slashable",
                                  "exit_from_the_future", "deposit_count",
                                  "attestation_target", "wrong_proposer",
                                  "parent_root"])
def test_rejected_block_raises_the_same_error(case):
    jspec, tspec = _specs("altair", shard_committee_period=1)
    h = StateHarness(N_VALIDATORS, J.MINIMAL, jspec, sign=False)
    h.state = JPS.process_slots(h.state, 2 * SPE - 1, J.MINIMAL, jspec)
    slot = h.state.slot + 1
    adv = JPS.process_slots(JPS.clone_state(h.state), slot, J.MINIMAL, jspec)
    signed, _ = h.produce_block(slot, h.attestations_for_slot(adv, slot - 1))
    block = signed.message
    if case == "wrong_proposer":
        block.proposer_index = (block.proposer_index + 1) % N_VALIDATORS
    elif case == "parent_root":
        block.parent_root = bytes(32)
    else:
        _reject(case)(block.body, h.state)
    jout, tout = _apply_both(h.state, signed, (jspec, tspec))
    assert isinstance(jout, str), case
    assert tout == jout
