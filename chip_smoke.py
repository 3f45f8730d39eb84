#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases (each one fails the run with a nonzero exit):

  build      compile the CUDA kernels from lighthouse_tpu_torch/csrc (one
             nvcc per source, started together) and load them
  kernels    each kernel against its plain PyTorch version on the card, at
             the main path's shapes (KERNEL_ROWS: fp_sq/fp_mul at the
             inversions' one row and at 1024 and 1000 rows, fp_sq also at
             2048, fp_mul also at 98,304 (the aggregate batch's largest
             launch of each), the Miller steps at 65 and 1025 pairs, the tower
             kernels at the final exponentiation's one row, fp6_mul also
             at 2 rows, fp12_mul also at the halving product's 64 and 32
             rows, and all three at a ragged 1025), on seeded lazy limbs,
             on every operand's limbs at the maximum 2^12, and on a mix
             of the two: torch.equal on int32, and at the first shape
             against the plain version run on the CPU; strided and
             broadcast tower operands too; each kernel also captured in
             a CUDA graph at its first shape and replayed on other inputs
             (every kernel runs inside the stage graphs on the main path);
             times: the wrapper's (events around calls, host work
             included) and the kernel's own device time per launch
             (torch.profiler)
  parity     a 4-set batch through the five stages on the card and on the
             CPU (plain versions): every stage output bit-identical; the
             same for _stage_agg_prep and for the pubkey rows that
             _marshal_batch gathers from a device table
  gossip     64 sets x 1 pubkey over 64 messages (the beacon processor's
             gossip batch) through api.verify_signature_sets: the per-set
             path; honest -> True, one wrong-message signature -> False
  aggregate  1024 sets x 2 pubkeys over 32 messages (tiled from 32 signed
             sets): the message-aggregated path; honest -> True, one
             forged set -> False
  warm       torch_cuda.warm_compile() over DEFAULT_WARM_BUCKETS: its
             report, and the card memory the graphs hold after it (so
             the table phase's pad_to=256 batch lands on a warmed bucket)
  table      a PubkeyTable of 2^20 validators on the card (the keys of the
             two batches tiled with filler keys), and both batches again
             with every key tagged by a validator index spread over the
             whole table, so _marshal_batch gathers the pubkey rows on the
             card: honest -> True, forged -> False, the same verdicts and
             the same pk tensor as the host-packed route, and the gossip
             batch once more with pad_to=256
  aggverify  api.aggregate_verify over the gossip batch's 64 pubkeys and 64
             distinct messages (65 pairs): honest -> True, one message
             swapped -> False
  graphs     the stage graphs (one CUDA graph per stage and shape,
             captured at a shape's first call, replayed after) for the
             4-set parity, gossip and aggregate batches: every stage's
             replayed outputs torch.equal to the plain stage's on the same
             marshalled batch; honest True, then the forged batch of the
             same bucket False, then honest True again, all replayed;
             capture seconds and replay ms per stage, and the card memory
             the graphs hold
  pipeline   the asynchronous seam (warm_compile first for any of its
             buckets not yet captured): one submit of each batch behind a
             ~1 s spinning kernel returns in well under the spin (a
             pageable copy under the same spin waits it out); 8 batches
             alternating gossip and aggregate (the second gossip forged)
             through api.verify_signature_sets_async at depth 2, every future's
             verdict equal to the sync verify's, and future N not done
             right after submit(N+1) returns for at least 6 of the 7
             (dispatch reads no device value); again with the keys tagged
             into the table when the table phase ran; the scheduler
             (LIGHTHOUSE_TPU_CONT_BATCH=1) merging four 16-set gossip
             entries on the block, aggregate, unaggregated and sync lanes
             into one launch padded to 64 with no new graph captured, and
             with one entry forged: one merge fallback, per-entry verdicts
             equal to the unmerged ones, still no capture; the fallback
             backend over a primary that fails its first call: the card's
             verdict, bls_backend_fallback_total + 1, the cpu oracle's
             seconds, and torch_cuda active again once the breaker's
             denied budget (2) is spent
  monolith   LIGHTHOUSE_TPU_MONOLITH=1 for the phase: the gossip batch and
             the aggregate batch through `verify_body` as ONE CUDA graph
             (the aggregate batch per set: 1024 hashes, 1025 Miller pairs),
             honest True and forged False, replayed and eager, the same
             verdicts as the staged route, launches as the code implies at
             65 and 1025 pairs; first-call, capture and warm replay
             seconds against the staged replay in the same run, the graph
             pools' MiB before and after, and the host ms to enqueue one
             replayed verify of each route; with --profile, the replayed
             and eager monolith profiled on both batches
  windowed   a child `python3 chip_smoke.py --phases build,windowed-child`
             with LIGHTHOUSE_TPU_PALLAS=1 (the switch is read at import, so
             only a fresh process can flip it); its nonzero exit fails the
             run. The child (phase windowed-child, not in the default
             list), on the gossip and aggregate batches: the windowed
             ladder's `prep` canon-equal to the bit ladder's
             (`_scalar_mul_u64_bit`, captured beside it), the windowed
             ladder on the card bit-identical to its plain version on the
             CPU at 4 rows of both groups, honest True and forged False
             through the entry point, launches as the code implies, and
             `prep` replay ms under both ladders, synchronized
  correct    the speculation correction: set_committee_aggregates over
             2048 committee aggregates (64 committees a slot x 32 slots, a
             mainnet epoch), then correct_aggregate_device for 1, 7 and 33
             absent members of a 512-member committee, each equal to the
             host aggregate of the present members; ms per call
  adversary  every probe family's batches for seed 0 and two honest
             controls through adversary.rejection_matrix over cpu,
             torch_per_set, torch_aggregated and fallback (the host-only
             cpu and fallback paths on the host pool, beside the card's),
             and once more through the monolith; the subgroup family also through the
             PubkeyTable route (the import refuses the poisoned keys). Any
             accepted probe, rejected control or disagreement between
             paths fails the run; the probe buckets and the monolith are
             warmed first, and their capture seconds reported
  block      one mainnet-shaped block's signatures, through the chain's
             wiring: the port's interop_genesis_state under MAINNET with
             altair at epoch 0, its registry tiled to 16,384 validators
             (4 committees of 128 a slot) from 1,024 distinct interop
             keys (a key costs ~19 ms of pure Python to decompress and
             subgroup-check in the pubkey cache, so 16,384 distinct ones
             would cost ~5 min; committee widths, set and key counts are
             the untiled registry's; the genesis state and the keys'
             checks made on a worker of the host pool from the run's
             start, beside the earlier phases), process_slots to slot 31, a
             ValidatorPubkeyCache whose device table is on the card; a
             SignedBeaconBlockAltair with 128 attestations (the 124
             committees of slots 0-30, all bits, and 4 more aggregates of
             slot 30's committees over other bit subsets), a full sync
             aggregate (512 keys), the randao reveal and the proposal:
             131 sets, 16,894 keys gathered by index. BlockSignatureVerifier
             with the cache's getter and resolver (every key table-tagged):
             honest True, one attestation signed over a wrong root False,
             the same verdicts as the cpu oracle on the same sets, the
             gathered pk equal to the host-packed one, launches as the
             code implies; host ms to build the sets and to marshal,
             first-call s and replayed ms
  attestations  gossip batches through a BeaconProcessor whose handlers
             submit them (`submit_*_batch`) and return the PendingBatch: 64
             unaggregated attestations of slot 30 from 64 distinct
             attesters and 32 SignedAggregateAndProofs (3 sets each) from
             members that is_aggregator selects, over the block phase's
             registry: every honest item verified, the same verdicts as
             the sync batch_verify_*; then the unaggregated batch with 1
             and with 3 planted forgeries and the aggregates with 1:
             exactly those rejected ("invalid
             signature"), every other item verified, the bisection within
             k (ceil(log2 n) + 1) extra backend calls; att_setup,
             verify-wait and bisection ms from the port's spans
  chain      block import through the port's BeaconChain (over a HotColdDB
             of a MemoryStore, on the registry's genesis; its pubkey cache
             is the one the block and attestations phases use), every
             verify on torch_cuda: the block phase's block at slot 31,
             now with its state root, through process_gossip_block (one
             backend call for the proposal, one for the other 130 sets;
             the head moves to it); a block at slot 32 through
             chain.process_block (VERIFY_BULK, 131 sets; process_slots runs
             process_epoch over the 16,384 validators on the way); a
             segment of 4 parent-linked blocks (33-36, each built on the
             post-state of the one before) through
             signature_verify_chain_segment, ONE backend call of 524 sets,
             then import_into; then, with the head unchanged after each,
             the same segment with attestation 5 of its third block forged
             (BlockError) and a block at 37 with a forged proposal
             signature ("invalid proposer signature"). Every call's
             verdict equals the cpu oracle's on the host pool; the head,
             its state root and the justified and finalized checkpoints
             equal a twin chain's that imported the same blocks with
             NO_VERIFICATION (in a worker process of its own, beside the
             phases; held to it when the registry's phases are done); each
             step launched the kernels as `expected_launches` implies for
             its calls' pairs. Printed: the span ms of each step (gossip
             verify, signature verify, transition, state root, fork
             choice, the whole import), process_epoch ms
             at the boundary, the segment's bucket, pairs, first-call s,
             replayed ms and host ms to build its sets, the phase's wall
  sync       the sync committee's traffic over the chain phase's chain
             (which it needs), every verify on torch_cuda: one slot's
             messages at the head, one a committee position (512, each
             position's key from its own holder), through the processor's
             gossip_sync_message queue: ONE sync-lane call of 512 sets over
             one root, into a SyncMessagePool and a ValidatorMonitor
             registered on the first 64 positions' senders; that slot's
             contributions (SYNC_AGGREGATORS a subnet, the senders whose
             selection proofs is_sync_committee_aggregator selects, each
             wrapping the pool's contribution of its subnet) through
             gossip_sync_contribution: one call of 3 sets each (selection
             proof, contribution-and-proof, the contribution's 128-key
             aggregate); both batches replayed; a sync-lane submit of the
             messages timed on an idle card and behind a ~1 s spin; the
             messages and the contributions with 1 planted forgery each:
             exactly those rejected, within the bisection bound;
             the SyncContributionPool's
             sync aggregate in the next block, which the chain imports; a
             LightClientStore bootstrapped at the genesis block follows
             the optimistic update that aggregate signs (512 keys gathered
             from the chain's table), and rejects the same update with one
             forged signature, its store unchanged; the monitor's count of
             the messages it saw
  pool       one slot's attestations over the chain's head (after the
             chain and sync phases): its 4 committees' 512 unaggregated
             attestations through the processor in batches of 64 into a
             NaiveAggregationPool (4 full aggregates) and an OperationPool;
             32 gossip aggregates with speculation off, then attach_speculation
             (256 committee aggregates parked on the card by
             set_committee_aggregates, corrections by correct_aggregate_device,
             each equal to the host's), the idle pass (4 speculative
             verifies) and the same aggregates with speculation on (equal
             verdicts, fewer keys); the next slot's aggregates confirmed by
             lookup (2 sets each); the speculation-poisoning audit; the
             block get_attestations packs, which the chain imports; an
             aggregate for that block that arrives first, waits in a
             ReprocessQueue and verifies once the block is imported; the
             SPECULATE_* counts. In both phases every call's launches are
             held to expected_launches, every verdict to the cpu oracle's,
             and the head and checkpoints to the twin chain's, which
             imports every block the chain imports without verifying
  genesis    genesis from eth1 deposits on the card (MINIMAL, its 64
             min_genesis_active_validator_count): 64 interop deposits
             signed on the host pool, in a DepositDataTree with their
             branches; try_genesis_from_eth1 over a stub service whose
             cached blocks cross min_genesis_time returns the state at the
             first qualifying block, initialize_beacon_state_from_eth1
             verifying each new key's proof of possession as one one-set
             call; the state valid, its root the `fake` backend's; again
             with a forged 65th deposit in the list: that key absent,
             every other validator and balance as before; an EF tree
             in the official layout (every kind of the official BLS suite
             for verify, fast_aggregate_verify, aggregate_verify and
             batch_verify, signed by the host oracle, and genesis
             initialization and validity cases of the run above) through
             the port's ef_tests.run_tree: every case ok. Printed for each
             call kind (deposit, verify, fast-aggregate, aggregate,
             batch): sets, keys, pairs, first-call s, replayed ms
  finality   the port's BeaconChainHarness (MINIMAL, 64 validators,
             sign=True: the host oracle signs) over a NativeStore under
             build/finality/, its chain on the card: extend_chain until
             the chain finalizes (at most 5 epochs), every block imported
             with VERIFY_BULK on torch_cuda; the head and checkpoints
             equal a NO_VERIFICATION twin's over a MemoryStore; a block
             whose attestation signature is forged rejected with the
             JAX harness chain's error, the head kept; run_fsck clean;
             the file reopened as a new NativeStore, from which
             BeaconChain.from_store resumes at the same head and
             finalized checkpoint; the STORE_NATIVE_* and STORE_FSCK_*
             counts; a block's seconds split into production (host
             signing, the post-state root), verify, the rest of the
             transition, store and fork choice. In both phases every
             call's launches are held to expected_launches and every
             verdict to the cpu oracle's
  merge      blocks past the merge, every verify on torch_cuda, the
             engine an in-process MockExecutionEngine behind an
             EngineRpcServer on a free localhost port, reached by the
             ExecutionLayer over HttpJsonRpcEngine with JWT (no retry
             policy: an engine that cannot be reached fails the import).
             (a) MAINNET over the registry's genesis, under
             ChainSpec.interop(altair 0, bellatrix 1) with the mock's
             terminal block as the terminal block hash (which leave the
             genesis root as it is); a BeaconChain on it, its table on
             the card, imports (through
             chain.process_block, one call of 131 sets each) the
             merge-transition block at 32 (process_epoch over 16,384
             validators and the bellatrix upgrade on the way; payload
             built on the terminal block before the block is signed) and
             payload-bearing blocks at 33 and 34: every payload VERIFIED,
             the head's known to the engine, the transition block not
             optimistic; then a block whose payload hash is tampered
             (re-signed: its call True, then PayloadInvalid with no engine
             request) and one with a forged attestation signature (False);
             the head the NO_VERIFICATION twin's. Printed a block: sets,
             keys, pairs, first-call s, replayed ms, the transition, state
             root, store and fork-choice spans, the engine's newPayload
             round trip, the host ms to build the payload and to sign.
             (b) MINIMAL, BeaconChainHarness(64, sign=True) under
             ChainSpec.interop(altair 1, bellatrix 2) over the same rig:
             the fork crossing (2 epochs and a block, a call a block,
             every bellatrix payload in the engine's log); two children
             of the head imported while the engine reports SYNCING
             (OPTIMISTIC), a
             third beside them, the first's payload marked invalid and
             the head reorged onto the third; a MockBuilder behind a
             BuilderHttpServer with 64 registrations over HTTP,
             InProcessBeaconNode.produce_blinded_block checking the bid
             on the card (one set), the signed blinded block unblinded
             and imported, a bid with its value raised refused ("bad
             builder bid signature", False); a MockEth1Provider behind an
             Eth1RpcServer read by JsonRpcEth1Provider into an
             Eth1Service, the beacon node voting a voting period's
             majority and packing the 2 owed deposits into the block that
             wins the vote: the honest one's key validator 64 and a row
             of the card's table equal to its host-packed limbs, the one
             signed over a wrong root skipped. Every server is stopped
             when the phase ends
  network    the gossip network on the card, every data-path signature
             on torch_cuda. (a) MAINNET over the registry's genesis and
             the in-process MessageBus: NetworkNodes a and b, each a
             BeaconChain with its table on the card, b with a slasher;
             a publishes the block at 31 (its own import, one call) and b
             imports it by gossip through its BeaconProcessor and
             process_gossip_block (calls of 1 and 130 sets); 64
             unaggregated attestations on their subnets verified by b as
             one batch (their verdict the cpu oracle's, all in b's naive
             pool); a forged one rejected and b's score of a down by
             GOSSIP_PENALTY; a double vote (the honest ValidatorStore
             refuses the second vote with NotSafe, a
             ByzantineValidatorStore with the same key signs it) carried
             as an aggregate, found by b's slasher, its AttesterSlashing
             checked by a in one call of 2 sets and pooled; a double
             proposal counted by BLOCK_EQUIVOCATIONS on b, its
             ProposerSlashing checked by a (2 sets); node c from genesis
             range-syncs block 31 from b, leaves, b imports the 4-block
             segment 32-35 by gossip, and c, back, range-syncs it through
             SyncManager in ONE call (~524 sets); a relays the segment
             (the chain phase's blocks 32-35 when it ran) without
             importing it; the heads of a, b, c the NO_VERIFICATION
             twin's at their blocks (the registry's twin, which the
             chain phase keeps). (b) MINIMAL over WireBus on
             127.0.0.1: a Bootnode and two nodes on secure channels
             with authenticated handshakes; the late joiner w1
             range-syncs w0's chain (the finality phase's blocks when it
             ran, else WIRE_BLOCKS) over the sockets in one call, then
             imports the last block from a gossip frame (ssz_snappy);
             an unreachable peer fails the phase. Node records, handshake
             transcripts and bootnode registrations are checked on the
             cpu oracle (control plane, as in the JAX package). Printed:
             each call's sets, keys, pairs, first-call s and replayed ms,
             the host ms of routing, encoding and decoding, and the
             control plane's verifies and ms. Every server and socket is
             closed when the phase ends
  http       the beacon API over HTTP and the validator client. (a)
             MAINNET: a BeaconChain on the registry's genesis (its table
             on the card) behind BeaconApiServer with a ServingTier; a
             BeaconNodeHttpClient posts block 31 (ONE call of its 131
             sets) while an SSE subscriber of block,head receives both
             events for its root; the head state's 16,384 validators,
             its committees, the head header and genesis read cold, then
             from the response cache (X-Cache hit, one more
             SERVING_CACHE_HITS) and revalidated (304); attester duties
             of every validator and proposer duties; HTTP_SYNC_MESSAGES
             sync-committee messages (one call each) and a forged one
             refused; a read-only GET shed with 503 and Retry-After under
             pressure forced through the admission's health source while
             a duty POST passes; /lighthouse/health from process_metrics
             and the SERVING_* families on /metrics. (b) interop keys in
             EIP-2335 keystores (scrypt at SCRYPT_N_LIGHT, one pbkdf2)
             imported over HTTP by a KeymanagerServer into a
             ValidatorStore (a wrong password refused), one more key
             behind a Web3SignerServer; a selection proof of each through
             the store, all verified in ONE call, False with two roots
             swapped. (c) a ValidatorClient of 16 distinct keys over
             BeaconNodeFallback([a closed port, a live client]) of a
             MINIMAL harness chain (altair) on the card, for an epoch:
             every block proposed over HTTP and imported on the card
             (one call a slot), no duty error, the graffiti in the head
             block, the closed port passed over, two of its sync messages
             posted over HTTP and verified; every head the
             NO_VERIFICATION twin's. Printed: each call's sets, keys,
             pairs, s and replayed ms; GET ms cold, cached and 304; the
             SSE ms from import to subscriber; keystore and Web3Signer ms;
             s a VC slot. Every server is stopped when the phase ends
  scenario   the scenario harness and the fuzzer at MINIMAL, torch_cuda the
             caller's backend on the card. A scenario swaps the backend to
             `fake` for its run and audits its probes on the cpu oracle, as
             in the JAX package, so the scenario runs launch no kernel:
             assert_bit_identical_replay of tests/test_scenarios.py's small
             partition plan (3 nodes, 48 validators, 33 slots) with every
             node chain on the default device, the card, then the plan with
             device="cpu": the same report, trace and ledger bytes, the
             backend torch_cuda on the card again after each run; both
             tests/fuzz_corpus entries replayed (the recorded reason under
             the plant, clean without it); then the phase's only card work,
             the first batch of each pairing probe family of
             aggregation_soundness_plan through torch_cuda (False, launches
             as its pairs imply) and the cpu oracle (False). Printed: each
             run's s and slots/s, the finalized epoch, the heads, the trace
             and ledger digests, memory_allocated before and after, the
             scenario runs' launches (0) and the probe verdicts

The script prints a {"phase_s": {...}} line: the wall seconds of each
phase and of the set-up between them (build, sign, registry, and twin:
the wait for the twin's last imports and its check).

The entry points run each stage as a CUDA graph: in every path the first
verify of a batch captures its stages and the verifies after it replay
them. Kernel launch counts are reset just before each honest main-path
verify (a replay) and read just after it; every kernel must have
launched, and each pairing kernel exactly as often as the code implies
(`expected_launches`: per verify 63 doubling and 5 addition steps, 316
cyclotomic squares, one fp6_mul, and 35 fp12_mul plus one per halving of
the Miller product). A replay counts the launches its capture recorded
(`kernels.count_replay`). The same run's launches by row count
(`row_tally`, taken around the kernels' launch and replay-count
functions) are logged. Each path also logs one verify of the same batch
through the plain (eager) stages, so eager and graphed latency come from
one run.

The script prints the card (nvidia-smi name and power limit), per-stage
ms and sets/s, one JSON line with every kernel's numbers, and as its last
line {"ok": true, "device": {...}}. Without a CUDA device it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

ALL_PHASES = (
    "build", "kernels", "parity", "gossip", "aggregate", "warm", "table",
    "aggverify", "graphs", "pipeline", "monolith", "windowed", "correct",
    "adversary", "block", "attestations", "chain", "sync", "pool", "genesis",
    "finality", "merge", "network", "http", "scenario",
)
# the phases that run over the MAINNET registry (built when one is asked for)
REGISTRY_PHASES = ("block", "attestations", "chain", "sync", "pool", "merge", "network",
                   "http")
# run only as the windowed phase's child process
CHILD_PHASES = ("windowed-child",)

# H100 SXM peaks. HBM: 3.35 TB/s (NVIDIA data sheet). int32: the CUDA C++
# Programming Guide's arithmetic-throughput table gives compute capability
# 9.0 64 32-bit integer multiply-adds per clock per SM, half its 128 fp32
# lanes, so half the data sheet's 67 TFLOP/s fp32: 33.5e12 ops/s with a
# multiply-add counted as 2 ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

W = 35
TPU_KERNELS = "lighthouse_tpu/crypto/bls/tpu/pallas_kernels.py"
KERNEL_META = {
    "fp_mul": ("lighthouse_tpu_torch/csrc/fp_kernels.cu", TPU_KERNELS + ":549"),
    "fp_sq": ("lighthouse_tpu_torch/csrc/fp_kernels.cu", TPU_KERNELS + ":567"),
    "miller_dbl_step": (
        "lighthouse_tpu_torch/csrc/miller_kernels.cu", TPU_KERNELS + ":735"),
    "miller_add_step": (
        "lighthouse_tpu_torch/csrc/miller_kernels.cu", TPU_KERNELS + ":754"),
    "fp6_mul": ("lighthouse_tpu_torch/csrc/tower_kernels.cu", TPU_KERNELS + ":708"),
    "fp12_mul": ("lighthouse_tpu_torch/csrc/tower_kernels.cu", TPU_KERNELS + ":718"),
    "fp12_cyclotomic_sq": (
        "lighthouse_tpu_torch/csrc/tower_kernels.cu", TPU_KERNELS + ":728"),
}
# each wrapper's CUDA kernel, as the profiler names it
KERNEL_SYMBOL = {
    "fp_mul": "fp_mul_kernel",
    "fp_sq": "fp_sq_kernel",
    "miller_dbl_step": "miller_dbl_kernel",
    "miller_add_step": "miller_add_kernel",
    "fp6_mul": "fp6_mul_kernel",
    "fp12_mul": "fp12_mul_kernel",
    "fp12_cyclotomic_sq": "fp12_cyclo_sq_kernel",
}


# rows the kernels phase runs each kernel at; the first is the main path's
# commonest shape, the one the JSON line reports (one row for fp_sq and
# fp_mul: 1900 of a gossip verify's 2725 fp_sq launches and 547 of its
# 1204 fp_mul launches, the Fermat inversions' chains); fp_sq and fp_mul
# also at the aggregate batch's largest launch of each, 2048 and 98,304 rows
KERNEL_ROWS = {
    "fp_mul": [1, 1024, 1000, 98304],
    "fp_sq": [1, 1024, 1000, 2048],
    "miller_dbl_step": [65, 1025],
    "miller_add_step": [65, 1025],
    "fp6_mul": [1, 2, 1025],
    "fp12_mul": [1, 64, 32, 1025],
    "fp12_cyclotomic_sq": [1, 1025],
}


def log(*a):
    print(*a, flush=True)


# --- operation and byte counts for the bound ----------------------------------


def _op_counts() -> dict:
    """int32 operations per row of each kernel's function, counted as a
    one-thread loop over the limbs does them (a multiply-add is 2; carries
    3 per limb per round; loads, stores and index arithmetic not counted);
    the square counts each cross product once, the least work for it,
    whatever its kernel does. The addition step counts z^2 and xq z^2 once
    (jac_madd's z1^2 and x2 z1^2 are the same functions of the same
    operands, and its kernel computes each once): its bound fell by one
    Fp2 square and one Fp2 product for that reason alone."""
    def carry3(w):
        return 3 * (3 * w + 3)

    def fold(w):
        return 2 * 32 * (w - 32) + carry3(32)

    reduce = carry3(69) + fold(72) + fold(35)
    norm = 35 + carry3(35) + fold(38)
    lincomb = 3 * 35 + carry3(35) + fold(38)  # a*ka + b*kb, normalized
    add1 = 35 + fold(35)
    mul_cols = 2 * 35 * 35
    sq_cols = 2 * 35 + 35 * 34 + 35  # a_i^2, then 2 a_i a_j for i < j
    fp_mul = mul_cols + reduce
    fp_sq = sq_cols + reduce
    a2 = 2 * add1
    fp2_mul = 3 * mul_cols + 2 * add1 + 3 * 69 + 2 * reduce
    fp2_sq = 2 * mul_cols + 2 * add1 + 69 + 2 * reduce
    xi = a2
    ms2 = 2 * norm
    mulfp = 2 * fp_mul
    fp6_mul = 6 * fp2_mul + 15 * a2 + 2 * xi
    fp12_sq = 2 * fp6_mul + 15 * a2 + 2 * xi
    s2 = 6 * fp2_mul + xi + 3 * a2
    s1 = 3 * fp2_mul + xi
    mul_by_line = 2 * s2 + s1 + 13 * a2 + xi
    jac_double = 5 * fp2_sq + 2 * fp2_mul + 5 * ms2 + 6 * a2
    jac_madd = 4 * fp2_sq + 7 * fp2_mul + 4 * ms2 + 9 * a2
    dbl_step = 3 * fp2_sq + 4 * fp2_mul + 4 * ms2 + a2 + 2 * mulfp + jac_double
    add_step = 5 * fp2_mul + 4 * a2 + 2 * mulfp + jac_madd  # z^2, xq z^2 shared
    fp12_mul = 3 * fp6_mul + 15 * a2 + xi
    cyclo_sq = 9 * fp2_sq + 12 * a2 + 4 * xi + 6 * 2 * lincomb
    return {
        "fp_mul": fp_mul,
        "fp_sq": fp_sq,
        "miller_dbl_step": dbl_step + fp12_sq + mul_by_line,
        "miller_add_step": add_step + mul_by_line,
        "fp6_mul": fp6_mul,
        "fp12_mul": fp12_mul,
        "fp12_cyclotomic_sq": cyclo_sq,
    }


# bytes per row: each input read once, each output written once (int32)
ROW_BYTES = {
    "fp_mul": 4 * W * 3,
    "fp_sq": 4 * W * 2,
    "miller_dbl_step": 4 * W * (12 + 6 + 1 + 1 + 12 + 6),
    "miller_add_step": 4 * W * (12 + 6 + 4 + 1 + 1 + 12 + 6),
    "fp6_mul": 4 * W * (6 + 6 + 6),
    "fp12_mul": 4 * W * (12 + 12 + 12),
    "fp12_cyclotomic_sq": 4 * W * (12 + 12),
}


def expected_launches(TP, pairs: int) -> dict:
    """Launches of the pairing kernels in one verify over `pairs` Miller
    pairs, as gpu/pairing.py implies: a doubling step per post-leading bit
    of |x| and an addition step per one-bit; the final exponentiation's
    five x-powers (`_pow_x_abs`) square at every bit and multiply at every
    one-bit, plus one cyclotomic square in the final product; fp12_mul
    twice in the easy part, once per x-chain step, and three times in the
    halving product of the five final factors (padded to 8); the Miller
    stage's halving product takes ceil(log2(pairs)) more; fp6_mul once,
    in fp12_inv's stacked product."""
    bits, ones = len(TP.BIT_TABLE), sum(TP.BIT_TABLE)
    return {
        "miller_dbl_step": bits,
        "miller_add_step": ones,
        "fp12_cyclotomic_sq": 5 * bits + 1,
        "fp12_mul": 2 + 5 * ones + 5 + (5 - 1).bit_length()
        + (pairs - 1).bit_length(),
        "fp6_mul": 1,
    }


@contextlib.contextmanager
def row_tally(K):
    """Within the block, tally each kernel's launches by row count: wraps
    the kernels module's `_launch` (which every wrapper calls; inside a
    graph capture it records and launches nothing) and `count_replay`
    (which every graph replay calls with its capture's record), and
    yields {kernel: {rows: launches}}, filled as launches happen."""
    tally = {k: {} for k in K.LAUNCHES}
    launch, replay = K._launch, K.count_replay

    def add(what, n):
        tally[what][n] = tally[what].get(n, 0) + 1

    def counted(what, lib, fn, outs, ins, n):
        launch(what, lib, fn, outs, ins, n)
        if n and getattr(K._capture, "log", None) is None:
            add(what, n)

    def counted_replay(record):
        replay(record)
        for what, n in record:
            add(what, n)

    K._launch, K.count_replay = counted, counted_replay
    try:
        yield tally
    finally:
        K._launch, K.count_replay = launch, replay


def launch_rows(tally) -> dict:
    """A row tally as {kernel: {rows: launches}} in ascending rows, the
    row counts as strings (JSON keys)."""
    return {k: {str(r): n for r, n in sorted(c.items())}
            for k, c in tally.items()}


def check_launches(label, counts, want):
    """Every kernel launched on the path; the pairing kernels as often as
    the code implies."""
    for name, n in counts.items():
        need(n > 0, f"{label}: kernel {name} never launched on the main path")
    for name, n in want.items():
        need(counts[name] == n, f"{label}: {counts[name]} {name} launches, "
             f"want {n}")


@contextlib.contextmanager
def env_pinned(**values):
    """The environment variables set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def add_launches(launches, counts):
    """Add one path's launch counts to the run's."""
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n


def bound(name: str, rows: int):
    t_bytes = ROW_BYTES[name] * rows / HBM_BYTES_PER_S
    t_ops = _op_counts()[name] * rows / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --- helpers ----------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _unmangle(nested: str) -> str:
    """The last identifier of a mangled nested name: the suffix that its
    decimal length prefix announces."""
    for i in range(len(nested)):
        m = re.match(r"\d+", nested[i:])
        if m and int(m.group()) == len(nested) - i - len(m.group()):
            return nested[i + len(m.group()):]
    return nested


def ptxas_summary(report: str) -> list:
    """One line per kernel (entry function) of an nvcc -Xptxas -v report:
    registers and cumulative stack; plus the most spill bytes of any
    function in the library."""
    out, kernel, spills = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+?_kernel)E", line)
        if m:
            kernel = _unmangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = max(spills, int(m.group(1)), int(m.group(2)))
        if kernel and "Used" in line:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}")
            kernel = None
    out.append(f"most spill bytes of any function: {spills}")
    return out


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def is_kernel_key(symbol: str, key: str) -> bool:
    """Whether a profiler event key (a demangled kernel name such as
    "(anonymous namespace)::fp_mul_kernel(int*, int const*, ...)") names the
    kernel `symbol`: whole identifier only, so fp_mul_kernel does not match
    fp6_mul_kernel or fp12_mul_kernel."""
    return re.search(r"(^|\W)%s(\W|$)" % re.escape(symbol), key) is not None


def device_ms(torch, fn, reps: int, symbol: str) -> float:
    """The device time per launch of kernel `symbol` over `reps` calls of
    `fn`: its self device time in torch.profiler's key_averages() over the
    launches the profiler recorded. The wrapper's host work and its
    operand copies (other kernels) are left out, so at a few microseconds a
    launch this is the kernel, where cuda_ms is the wrapper. The profiler
    may miss a launch at the edge of its window, and a process's first
    profiling pass has come back empty on a fresh machine: a pass that saw
    fewer than half the launches is logged and made again, three times at
    most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and is_kernel_key(symbol, e.key)]
        count = sum(e.count for e in hits)
        if reps // 2 <= count <= reps:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        log(f"profiler saw {count} launches of {symbol} in {reps} calls "
            f"(pass {attempt + 1} of 3)")
    raise Fail(f"profiler never saw the launches of {symbol}")


class Fail(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise Fail(msg)


# --- phases ---------------------------------------------------------------------


def phase_kernels(torch, K, CG, results):
    """Each kernel against its plain version at the main path's shapes,
    launched eagerly and replayed in a CUDA graph."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def lazy(rows, slots, maximal):
        if maximal:
            return torch.full((rows, slots, W), 4096, dtype=torch.int32, device=dev)
        a = rng.integers(-1, 4097, size=(rows, slots, W), dtype=np.int32)
        return torch.as_tensor(a).to(dev)

    # kinds of input: seeded lazy limbs; every operand's limbs at 2^12 (the
    # worst-case column sums that pin the int32 overflow analysis); and
    # the first operands maximal against seeded lazy ones
    kinds = ("lazy", "maximal", "mixed")

    tower_slots = {"fp6_mul": (3, 2), "fp12_mul": (2, 3, 2),
                   "fp12_cyclotomic_sq": (2, 3, 2)}

    def inputs(name, rows, kind):
        first, rest = kind != "lazy", kind == "maximal"
        if name in tower_slots:
            shape = (rows,) + tower_slots[name] + (W,)
            slots = math.prod(tower_slots[name])
            a = lazy(rows, slots, first).reshape(shape)
            if name == "fp12_cyclotomic_sq":
                return (a,)
            return (a, lazy(rows, slots, rest).reshape(shape))
        if name in ("fp_mul", "fp_sq"):
            a = lazy(rows, 1, first)[:, 0]
            return (a, lazy(rows, 1, rest)[:, 0]) if name == "fp_mul" else (a,)
        f = lazy(rows, 12, first).reshape(rows, 2, 3, 2, W)
        t = lazy(rows, 6, first).reshape(rows, 3, 2, W)
        xp, yp = lazy(rows, 1, first)[:, 0], lazy(rows, 1, rest)[:, 0]
        if name == "miller_dbl_step":
            return (f, t, xp, yp)
        return (f, t, lazy(rows, 4, rest).reshape(rows, 2, 2, W), xp, yp)

    pairs = {
        "fp_mul": (K.fp_mul, K.fp_mul_plain),
        "fp_sq": (K.fp_sq, K.fp_sq_plain),
        "miller_dbl_step": (K.miller_dbl_step, K.miller_dbl_step_plain),
        "miller_add_step": (K.miller_add_step, K.miller_add_step_plain),
        "fp6_mul": (K.fp6_mul, K.fp6_mul_plain),
        "fp12_mul": (K.fp12_mul, K.fp12_mul_plain),
        "fp12_cyclotomic_sq": (K.fp12_cyclotomic_sq, K.fp12_cyclotomic_sq_plain),
    }
    for name, sizes in KERNEL_ROWS.items():
        err = 0
        kern, plain = pairs[name]
        for rows in sizes:
            for kind in kinds:
                args = inputs(name, rows, kind)
                got = kern(*args)
                torch.cuda.synchronize()
                want = plain(*args)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    err = max(err, int((g.long() - w.long()).abs().max()))
                    need(torch.equal(g, w), f"{name} rows={rows} {kind}: "
                         "kernel differs from its plain version")
                if rows == sizes[0] and kind == "lazy":
                    # and against the plain version on the CPU, same inputs
                    cpu = plain(*(x.cpu() for x in args))
                    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
                    for g, w in zip(got, cpu):
                        need(torch.equal(g.cpu(), w), f"{name}: card != CPU plain")
        # replayed: captured at the first shape on lazy inputs, replayed on
        # mixed ones (the replay must read its new inputs)
        graph = CG.graphed(kern)
        graph(*inputs(name, sizes[0], "lazy"))
        args = inputs(name, sizes[0], "mixed")
        got, want = graph(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            need(torch.equal(g, w), f"{name} rows={sizes[0]}: graph replay "
                 "differs from its plain version")
        timing = {}
        for rows in sizes:  # time at every shape, lazy inputs
            args = inputs(name, rows, "lazy")
            timing[rows] = (
                cuda_ms(torch, lambda: kern(*args), reps=20),
                device_ms(torch, lambda: kern(*args), 20, KERNEL_SYMBOL[name]),
                cuda_ms(torch, lambda: plain(*args), reps=3),
            )
        rows = sizes[0]  # the JSON line reports the first (main-path) shape
        ms, dev_ms, plain_ms = timing[rows]
        bound_ms, bound_by = bound(name, rows)
        results[name] = dict(
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, rows=rows,
        )
        for r, (k_ms, d_ms, p_ms) in timing.items():
            b_ms, b_by = bound(name, r)
            log(f"kernel {name}: {r} rows: device {d_ms:.4f} ms a launch, "
                f"wrapper {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})")
        log(f"kernel {name}: equal to its plain version at rows {sizes} "
            f"on inputs {kinds}, and replayed in a CUDA graph at "
            f"{sizes[0]} rows, max_abs_err {err}")
    # the operand layouts the path hands the tower wrappers: fp12_prod's
    # strided halves, fp12_inv's broadcast inverse, a lone row
    f = lazy(65, 12, False).reshape(65, 2, 3, 2, W)
    tower_calls = [
        ("fp12_mul", K.fp12_mul, K.fp12_mul_plain, (f[0:64:2], f[1::2])),
        ("fp12_mul", K.fp12_mul, K.fp12_mul_plain, (f[:3], f[3])),
        ("fp6_mul", K.fp6_mul, K.fp6_mul_plain,
         (f[:2, 0], f[2, 1].unsqueeze(0))),
        ("fp12_cyclotomic_sq", K.fp12_cyclotomic_sq,
         K.fp12_cyclotomic_sq_plain, (f[64],)),
        ("fp12_cyclotomic_sq", K.fp12_cyclotomic_sq,
         K.fp12_cyclotomic_sq_plain, (f[0:64:2],)),
    ]
    for name, kern, plain, args in tower_calls:
        got, want = kern(*args), plain(*args)
        need(got.shape == want.shape and torch.equal(got, want),
             f"{name}: kernel differs from its plain version on operands "
             f"{[tuple(a.shape) for a in args]}, strides "
             f"{[a.stride() for a in args]}")
    log("kernels fp6_mul, fp12_mul, fp12_cyclotomic_sq: equal to their plain "
        "versions on strided, broadcast and unbatched operands")


def _stage_timer(torch, times, outs=None):
    def timer(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*args)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if outs is not None:
            outs[name] = r
        return r
    return timer


def eager_stages(name, fn, *args):
    """A stage timer that runs each stage's plain function (`.fn` of its
    graphs) instead of its graph: the eager route."""
    return fn.fn(*args)


def parity_sets(api):
    """4 single-pubkey sets over 3 messages (the per-set path, 5 Miller
    pairs), plus a forged copy with set 1 under set 0's signature."""
    sks = [api.SecretKey(7001 + i) for i in range(4)]
    msgs = [b"parity-%d" % (i % 3) for i in range(4)]
    sets = [api.SignatureSet.single_pubkey(sk.sign(m), sk.public_key(), m)
            for sk, m in zip(sks, msgs)]
    forged = list(sets)
    forged[1] = api.SignatureSet.single_pubkey(
        sets[0].signature, sets[1].pubkeys[0], sets[1].message)
    return sets, forged


def phase_parity(torch, api, B, sets):
    """A 4-set batch: every stage output on the card equals the CPU's."""
    outs = {}
    for dev in ("cuda", "cpu"):
        o = {}
        mb = B._marshal_batch(sets, dev, seed=5)
        if dev == "cuda":
            verdict = B.run_marshalled(mb, timer=_stage_timer(torch, {}, o))
        else:
            verdict = B.run_marshalled(mb, timer=lambda n, fn, *a: o.setdefault(n, fn(*a)))
        o["verdict"] = verdict
        outs[dev] = o

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]

    for name in outs["cpu"]:
        for g, w in zip(flat(outs["cuda"][name]), flat(outs["cpu"][name])):
            need(torch.equal(g.cpu(), w), f"parity: stage {name} differs card vs CPU")
    need(bool(outs["cuda"]["verdict"]), "parity: honest 4-set batch rejected")
    log(f"parity: stages {sorted(outs['cpu'])} bit-identical card vs CPU; verdict True")

    # aggregate_verify's own stage, and the pubkey rows gathered from a
    # device table, card vs CPU
    pk = torch.stack([torch.as_tensor(B._pk_limbs(s.pubkeys[0])) for s in sets])
    sig = torch.as_tensor(B._sig_limbs(sets[0].signature))
    real = torch.tensor([True, True, True, False])
    prep = {dev: B._stage_agg_prep(pk.to(dev), sig.to(dev), real.to(dev))
            for dev in ("cuda", "cpu")}
    for g, w in zip(prep["cuda"], prep["cpu"]):
        need(torch.equal(g.cpu(), w), "parity: _stage_agg_prep differs card vs CPU")
    gathered = {}
    for dev in ("cuda", "cpu"):
        table = B.PubkeyTable(dev)
        table.import_new_pubkeys([s.pubkeys[0] for s in reversed(sets)])
        tagged = tag_sets(api, sets, table, lambda i, j, key: 3 - i)
        gathered[dev] = B._marshal_batch(tagged, dev, seed=5).pk
    need(torch.equal(gathered["cuda"].cpu(), gathered["cpu"]),
         "parity: gathered pubkey rows differ card vs CPU")
    need(torch.equal(gathered["cpu"], B._marshal_batch(sets, "cpu", seed=5).pk),
         "parity: gathered pubkey rows differ from the host-packed ones")
    log("parity: _stage_agg_prep outputs and the table-gathered pk rows "
        "bit-identical card vs CPU (and equal to the host-packed pk)")


def tag_sets(api, sets, table, index):
    """The sets with every pubkey replaced by a copy tagged with `table`
    and the validator index `index(set i, key j, key)`, as the chain's
    validator pubkey cache tags its keys."""
    out = []
    for i, s in enumerate(sets):
        keys = []
        for j, key in enumerate(s.pubkeys):
            tagged = api.PublicKey(key.point, subgroup_checked=True)
            tagged.validator_index = index(i, j, key)
            tagged.table = table
            keys.append(tagged)
        out.append(api.SignatureSet.multiple_pubkeys(s.signature, keys, s.message))
    return out


def _verify_timed(torch, B, sets, seed):
    times = {}
    t0 = time.perf_counter()
    mb = B._marshal_batch(sets, "cuda", seed=seed)
    t1 = time.perf_counter()
    verdict = bool(B.run_marshalled(mb, timer=_stage_timer(torch, times)))
    t2 = time.perf_counter()
    times["marshal"] = (t1 - t0) * 1e3
    return verdict, times, (t2 - t0), mb.grid_idx is not None


def run_path(torch, K, TP, B, api, label, sets, forged, pairs, launches, card,
             profile):
    """One batch through `api.verify_signature_sets`, the user's entry
    point: a warm-up verify (at a new bucket it captures the stage
    graphs), then the counted verify (a replay; launch counts reset just
    before it and read just after), then the forged batch; per-stage ms
    come from one more verify of the same batch under the stage timer
    (replays, synchronized), and the eager latency from one verify of the
    same batch through the plain stages."""
    t0 = time.perf_counter()
    need(api.verify_signature_sets(sets, seed=10), f"{label}: warm-up rejected")
    first_secs = time.perf_counter() - t0
    with row_tally(K) as tally:
        K.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(sets, seed=11)
        secs = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
    rows = launch_rows(tally)
    need(ok, f"{label}: honest batch rejected")
    check_launches(label, counts, expected_launches(TP, pairs))
    add_launches(launches, counts)
    log(f"{label}: launches by rows {json.dumps(rows)}")
    staged_ok, times, staged_secs, aggregated = _verify_timed(torch, B, sets, seed=12)
    need(staged_ok, f"{label}: staged (timed) verify rejected")
    stages = " ".join(f"{k}={v:.1f}" for k, v in times.items())
    log(f"{label}: honest True, {len(sets)} sets, "
        f"{'aggregated' if aggregated else 'per-set'} path, {secs:.3f} s, "
        f"{len(sets) / secs:.2f} sets/s; launches {counts}; card: {card}")
    log(f"{label}: stage ms (graphs replayed, synchronized, "
        f"{staged_secs:.3f} s): {stages}")
    t0 = time.perf_counter()
    bad = api.verify_signature_sets(forged, seed=13)
    need(not bad, f"{label}: forged batch accepted")
    log(f"{label}: forged False, {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_ok = bool(B.run_marshalled(B._marshal_batch(sets, "cuda", seed=14),
                                     timer=eager_stages))
    eager_secs = time.perf_counter() - t0
    need(eager_ok, f"{label}: eager verify rejected")
    log(f"{label}: latency graphed {secs:.3f} s (replay), eager {eager_secs:.3f} s "
        f"(plain stages), first verify {first_secs:.3f} s (captures at a new "
        f"bucket); card: {card}")
    out = dict(sets=len(sets), seconds=secs, eager_seconds=eager_secs,
               first_seconds=first_secs, stage_ms=times, aggregated=aggregated,
               launches=counts, launch_rows=rows)
    if profile:
        out["profile"] = profile_verify(torch, K, B, sets, label)
    return out


TABLE_ROWS = 1 << 20  # validators: the order of the mainnet registry


def phase_table(torch, K, TP, B, api, batches, launches, card, tagged_out):
    """A 2^20-row PubkeyTable on the card, filled by tiling the batches'
    keys and filler keys; each batch again with its keys tagged by indices
    spread over the whole table (row r holds base key r % len(base)). The
    tagged batches go into `tagged_out[label]` as (sets, forged)."""
    import numpy as np

    base, pos = [], {}
    for sets, _, _ in batches.values():
        for s in sets:
            for key in s.pubkeys:
                xy = (key.point.x.n, key.point.y.n)
                if xy not in pos:
                    pos[xy] = len(base)
                    base.append(key)
    filler = 256 - len(base)
    base += [api.SecretKey(900001 + i).public_key() for i in range(filler)]
    nb = len(base)
    t_start = time.perf_counter()
    table = B.PubkeyTable("cuda")
    table.import_new_pubkeys([base[r % nb] for r in range(TABLE_ROWS)])
    t_imported = time.perf_counter()
    dev_table = table.device_table()
    torch.cuda.synchronize()
    import_ms = (t_imported - t_start) * 1e3
    upload_ms = (time.perf_counter() - t_imported) * 1e3
    need(len(table) == TABLE_ROWS and dev_table.shape == (TABLE_ROWS, 3, W),
         f"table: {len(table)} keys, device table {tuple(dev_table.shape)}")
    log(f"table: {TABLE_ROWS} validators ({dev_table.numel() * 4 / 1e6:.1f} MB on "
        f"the card) from {nb} distinct keys ({filler} filler): host import "
        f"{import_ms:.1f} ms, upload {upload_ms:.1f} ms; card: {card}")

    def spreader(sets):
        """Indices for the batch's keys, each a row holding that key, in
        even steps from the first rows of the table to its last."""
        total = sum(len(s.pubkeys) for s in sets)
        steps = iter(range(total))
        q_max = TABLE_ROWS // nb - 1
        return lambda i, j, key: pos[(key.point.x.n, key.point.y.n)] + nb * (
            next(steps) * q_max // max(total - 1, 1))

    out = {}
    for label, (sets, forged, pairs) in batches.items():
        label = "table-" + label
        tagged = tag_sets(api, sets, table, spreader(sets))
        tagged_forged = tag_sets(api, forged, table, spreader(forged))
        tagged_out[label[len("table-"):]] = (tagged, tagged_forged)
        idx = np.asarray([[k.validator_index for k in s.pubkeys] for s in tagged])
        need(idx.min() < TABLE_ROWS // 16 and idx.max() > TABLE_ROWS * 15 // 16,
             f"{label}: indices {idx.min()}..{idx.max()} do not span the table")
        mb_t = B._marshal_batch(tagged, "cuda", seed=21)
        mb_h = B._marshal_batch(sets, "cuda", seed=21)
        need(torch.equal(mb_t.pk, mb_h.pk),
             f"{label}: gathered pk differs from the host-packed pk")
        idx_pack = B._pack_index_batch(tagged, *mb_t.pk.shape[:2])[0]
        gather_ms = cuda_ms(torch, lambda: table.gather(idx_pack), reps=10)
        K.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(tagged, seed=21)
        secs = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        need(ok, f"{label}: honest batch rejected")
        check_launches(label, counts, expected_launches(TP, pairs))
        add_launches(launches, counts)
        need(api.verify_signature_sets(sets, seed=21) == ok,
             f"{label}: host-packed route disagrees")
        t0 = time.perf_counter()
        bad = api.verify_signature_sets(tagged_forged, seed=22)
        bad_secs = time.perf_counter() - t0
        need(not bad, f"{label}: forged batch accepted")
        need(api.verify_signature_sets(forged, seed=22) == bad,
             f"{label}: host-packed route disagrees on the forged batch")
        log(f"{label}: honest True, {len(sets)} sets gathered by index from the "
            f"{TABLE_ROWS}-row table, {secs:.3f} s, {len(sets) / secs:.2f} sets/s; "
            f"forged False, {bad_secs:.3f} s; gather {gather_ms:.4f} ms; "
            f"pk equal to the host-packed route, verdicts equal; launches {counts}")
        out[label] = dict(sets=len(sets), seconds=secs, forged_seconds=bad_secs,
                          gather_ms=gather_ms, launches=counts)
        if label == "table-gossip":
            mb = B._marshal_batch(tagged, "cuda", seed=23, pad_to=256)
            need(mb.real.shape[0] == 256 and mb.grid_idx is None,
                 f"{label}: pad_to=256 marshalled n_b {mb.real.shape[0]}")
            t0 = time.perf_counter()
            ok = bool(B.dispatch_verify_signature_sets(
                tagged, seed=23, pad_to=256, device="cuda"))
            need(ok, f"{label}: honest batch rejected with pad_to=256")
            pad_secs = time.perf_counter() - t0
            log(f"{label}: pad_to=256 (n_b 256, per-set shape) True, {pad_secs:.3f} s")
            out[label]["pad_to_256_seconds"] = pad_secs
    out["table"] = dict(rows=TABLE_ROWS, distinct_keys=nb,
                        import_ms=import_ms, upload_ms=upload_ms)
    return out


def phase_aggverify(torch, K, TP, B, api, gossip, launches, card):
    """api.aggregate_verify over the gossip batch's 64 pubkeys and 64
    distinct messages under the sum of its signatures (65 pairs)."""
    sets = gossip[0]
    sig = api.AggregateSignature.aggregate([s.signature for s in sets]).to_signature()
    pks = [s.pubkeys[0] for s in sets]
    msgs = [s.message for s in sets]
    need(api.aggregate_verify(sig, pks, msgs), "aggverify: warm-up rejected")
    K.reset_launches()
    t0 = time.perf_counter()
    ok = api.aggregate_verify(sig, pks, msgs)
    secs = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    need(ok, "aggverify: honest aggregate rejected")
    check_launches("aggverify", counts, expected_launches(TP, len(pks) + 1))
    add_launches(launches, counts)
    swapped = list(msgs)
    swapped[9] = b"not the attested data"
    t0 = time.perf_counter()
    bad = api.aggregate_verify(sig, pks, swapped)
    bad_secs = time.perf_counter() - t0
    need(not bad, "aggverify: aggregate over a swapped message accepted")
    times = {}
    need(B.aggregate_verify(sig, pks, msgs, device="cuda",
                            timer=_stage_timer(torch, times)),
         "aggverify: staged (timed) verify rejected")
    stages = " ".join(f"{k}={v:.1f}" for k, v in times.items())
    log(f"aggverify: honest True, {len(pks)} pubkeys over {len(msgs)} messages, "
        f"{secs:.3f} s; swapped message False, {bad_secs:.3f} s; launches "
        f"{counts}; card: {card}")
    log(f"aggverify: stage ms (synchronized): {stages}")
    return dict(pubkeys=len(pks), seconds=secs, forged_seconds=bad_secs,
                stage_ms=times, launches=counts)


def profile_verify(torch, K, B, sets, label, monolith=False):
    """For the replayed route (the stage graphs) and the eager route (the
    plain stages): one warm verify of the marshalled batch without the
    profiler (its wall time), then the same verify under torch.profiler:
    device busy time (sum of kernel times on the one stream), the kernels
    that take the most of it, each hand-written kernel's launches and
    device time, whether the profiler saw every hand-written kernel launch
    that the verify counted (inside a replay too), and the idle share
    1 - busy / unprofiled wall (the profiler's own host cost stretches its
    wall, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    mb = B._marshal_batch(sets, "cuda", seed=13)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdict = bool(fn())
        torch.cuda.synchronize()
        need(verdict, f"{label}: profiled verify rejected")
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for route, timer in (("replay", None), ("eager", eager_stages)):
        wall_ms = wall(lambda: B.run_marshalled(mb, timer=timer, monolith=monolith))
        K.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_wall_ms = wall(
                lambda: B.run_marshalled(mb, timer=timer, monolith=monolith))
        counted = dict(K.LAUNCHES)
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        port = {}  # each hand-written kernel: (launches, device ms) in the verify
        for name, symbol in KERNEL_SYMBOL.items():
            hits = [e for e in kernels if is_kernel_key(symbol, e.key)]
            port[name] = (sum(e.count for e in hits),
                          sum(e.self_device_time_total for e in hits) / 1e3)
        seen_all = all(port[n][0] == c for n, c in counted.items())
        # the profiled verify's device span, first kernel start to last
        # kernel end, and the gaps between kernels inside it: taken with the
        # profiler on, whose host cost stretches the host's launches, so
        # they show how the device waits on a slower host, not the gaps of
        # the unprofiled wall
        spans = [e.time_range for e in prof.events() if e.device_type.name == "CUDA"]
        span_ms = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e3
        summary = dict(
            wall_ms=wall_ms, profiled_wall_ms=profiled_wall_ms,
            device_busy_ms=busy_us / 1e3, idle_share=1 - busy_us / 1e3 / wall_ms,
            device_span_ms=span_ms, gaps_in_span_ms=span_ms - busy_us / 1e3,
            device_kernels=launches, profiler_saw_every_launch=seen_all,
            top=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
            port_kernels=port,
        )
        tag = f"{label} profile ({route})"
        log(f"{tag}: wall {wall_ms:.1f} ms (profiler off; "
            f"{profiled_wall_ms:.1f} ms on), device busy {busy_us / 1e3:.1f} ms, "
            f"idle share {summary['idle_share']:.4f} of the unprofiled wall, "
            f"{launches} device kernels; device span {span_ms:.1f} ms, gaps "
            f"inside it {span_ms - busy_us / 1e3:.1f} ms")
        for key, count, ms in summary["top"]:
            log(f"{tag}:   {ms:9.2f} ms  {count:7d}x  {key}")
        log(f"{tag}: hand-written kernels (launches, device ms): "
            + ", ".join(f"{n} {c} {ms:.3f}" for n, (c, ms) in port.items()))
        log(f"{tag}: the profiler saw {'every' if seen_all else 'NOT every'} "
            f"hand-written kernel launch the verify counted {counted}")
        out[route] = summary
    return out


def graph_pool_bytes(torch) -> int:
    """Card memory held by the CUDA-graph pools: the segments of every
    private pool in the caching allocator's snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def memory_line(torch) -> dict:
    """The graph pools' bytes and the allocator's reserved bytes, after
    returning the unused cached blocks."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(graph_pools=graph_pool_bytes(torch),
                reserved=torch.cuda.memory_reserved())


def mib(n: int) -> str:
    return f"{n / 2**20:.1f} MiB"


def phase_graphs(torch, K, TP, B, CG, batches, launches, card):
    """Each batch marshalled once: its first verify captures the stage
    graphs at its bucket (unless an earlier phase did), the plain stages
    give the eager outputs, a replay under the stage timer gives each
    stage's outputs (torch.equal to the eager ones) and replay ms; then a
    counted replay (honest True, launch counts as the code implies), the
    forged batch of the same bucket (False) and the honest one again
    (True), all replayed."""
    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]

    out = {}
    for label, (sets, forged, pairs) in batches.items():
        tag = f"graphs {label}"
        mb = B._marshal_batch(sets, "cuda", seed=31)
        mb_bad = B._marshal_batch(forged, "cuda", seed=31)
        bucket = B._shape_bucket(mb)
        need(B._shape_bucket(mb_bad) == bucket,
             f"{tag}: forged batch bucket {B._shape_bucket(mb_bad)} != {bucket}")
        t0 = time.perf_counter()
        need(bool(B.run_marshalled(mb)), f"{tag}: first verify rejected")
        first_secs = time.perf_counter() - t0
        want = {}
        B.run_marshalled(
            mb, timer=lambda n, fn, *a: want.setdefault(n, eager_stages(n, fn, *a)))
        got, replay_ms, capture_s = {}, {}, {}
        timed = _stage_timer(torch, replay_ms, got)

        def replayed(name, fn, *args):
            capture_s[name] = fn.capture_seconds[CG.shape_key(args)]
            return timed(name, fn, *args)

        B.run_marshalled(mb, timer=replayed)
        for name in want:
            for g, w in zip(flat(got[name]), flat(want[name])):
                need(torch.equal(g, w),
                     f"{tag}: stage {name} replay differs from its plain stage")
        K.reset_launches()
        t0 = time.perf_counter()
        ok = bool(B.run_marshalled(mb))
        secs = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        need(ok, f"{tag}: honest batch rejected on replay")
        check_launches(tag, counts, expected_launches(TP, pairs))
        add_launches(launches, counts)
        need(not bool(B.run_marshalled(mb_bad)),
             f"{tag}: forged batch accepted on replay")
        need(bool(B.run_marshalled(mb)),
             f"{tag}: honest batch rejected on replay after the forged one")
        log(f"{tag}: bucket {bucket}, every stage's replayed outputs equal to "
            f"its plain stage's; honest True, forged False, honest True, "
            f"replayed; first verify {first_secs:.3f} s, replayed verify "
            f"{secs:.3f} s; launches {counts}; card: {card}")
        log(f"{tag}: capture s (a stage's first call at its shape: eager run "
            "and capture) " + " ".join(f"{k}={v:.3f}" for k, v in capture_s.items()))
        log(f"{tag}: replay ms (synchronized) "
            + " ".join(f"{k}={v:.2f}" for k, v in replay_ms.items()))
        out[label] = dict(bucket=bucket, first_seconds=first_secs, seconds=secs,
                          capture_seconds=capture_s, replay_ms=replay_ms,
                          launches=counts)
    mem = memory_line(torch)
    log(f"graphs: the card's graph pools hold {mib(mem['graph_pools'])}, "
        f"reserved {mib(mem['reserved'])}; card: {card}")
    out["memory"] = mem
    return out


def phase_warm(torch, B, card):
    """torch_cuda.warm_compile() over DEFAULT_WARM_BUCKETS, with the graph
    pools' memory before and after it."""
    before = memory_line(torch)
    t0 = time.perf_counter()
    report = B.warm_compile()
    secs = time.perf_counter() - t0
    after = memory_line(torch)
    need([r["bucket"][:3] for r in report] == list(B.DEFAULT_WARM_BUCKETS),
         f"warm: report {report}")
    for r in report:
        log(f"warm: bucket {r['bucket']} {r['seconds']:.3f} s, "
            f"{'captured' if r['compiled'] else 'already captured'}")
    log(f"warm: {len(report)} buckets in {secs:.1f} s; graph pools "
        f"{mib(before['graph_pools'])} -> {mib(after['graph_pools'])}, reserved "
        f"{mib(before['reserved'])} -> {mib(after['reserved'])}; card: {card}")
    return dict(report=report, seconds=secs, memory_before=before,
                memory_after=after)


# --- the asynchronous seam: pipeline, scheduler, fallback -------------------

STREAM_K = 8  # batches in each pipeline stream
# the bucketed shapes the pipeline phase runs: the gossip batch (per-set),
# the aggregate batch (grid), the scheduler's 16-set entries at their
# natural bucket (per-set), and the 4-set fallback batch
PIPELINE_BUCKETS = ((64, 4, 64), (1024, 4, 32), (16, 4, 16), (4, 4, 4))


def graph_count(B) -> int:
    """Stage graphs captured so far, over every stage and shape."""
    names = ("_hash_graphs", "_prep_graphs", "_miller_graphs", "_final_graphs",
             "_group_graphs", "_agg_prep_graphs", "_monolith_graphs",
             "_correct_graphs")
    return sum(len(getattr(B, n).graphs) for n in names if hasattr(B, n))


def pipeline_stream(torch, K, TP, api, P, label, stream, launches, card):
    """`stream` ([(sets, pairs)], alternating gossip and aggregate) through
    api.verify_signature_sets_async at depth 2: each future's verdict
    equals the sync verify's of the same sets and seed, and right after
    submit(N+1) returns, future N is not done for at least K - 2 batches
    (a host sync in dispatch would have finished it). Launch counts are
    reset just before the stream's submits and read after its results."""
    k = len(stream)
    seeds = [60 + i for i in range(k)]
    sync_verdicts, sync_secs = [], []
    for (sets, _), seed in zip(stream, seeds):
        t0 = time.perf_counter()
        sync_verdicts.append(api.verify_signature_sets(sets, seed=seed))
        sync_secs.append(time.perf_counter() - t0)
    P.configure(depth=2)
    torch.cuda.synchronize()
    K.reset_launches()
    futures, submit_ms, not_done = [], [], []
    t_start = time.perf_counter()
    for (sets, _), seed in zip(stream, seeds):
        t0 = time.perf_counter()
        futures.append(api.verify_signature_sets_async(sets, seed=seed))
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        if len(futures) > 1:
            not_done.append(not futures[-2].done())
    verdicts = [f.result() for f in futures]
    wall = time.perf_counter() - t_start
    counts = dict(K.LAUNCHES)
    want = {}
    for _, pairs in stream:
        for name, n in expected_launches(TP, pairs).items():
            want[name] = want.get(name, 0) + n
    n_sets = sum(len(sets) for sets, _ in stream)
    log(f"{label}: {k} batches ({n_sets} sets) at depth 2, verdicts {verdicts}, "
        f"sync {sync_verdicts}; future N not done after submit(N+1): "
        f"{sum(not_done)} of {k - 1}")
    log(f"{label}: host ms per submit {[round(x, 2) for x in submit_ms]}; stream "
        f"wall {wall:.3f} s, {n_sets / wall:.1f} sets/s; sum of the {k} sync "
        f"latencies {sum(sync_secs):.3f} s ({n_sets / sum(sync_secs):.1f} sets/s); "
        f"card: {card}")
    check_launches(label, counts, want)
    add_launches(launches, counts)
    need(verdicts == sync_verdicts,
         f"{label}: futures {verdicts} != sync verdicts {sync_verdicts}")
    need(sum(not_done) >= k - 2,
         f"{label}: future N already done right after submit(N+1) in "
         f"{not_done.count(False)} of {k - 1} batches (a host sync in dispatch?)")
    return dict(batches=k, sets=n_sets, submit_ms=submit_ms, wall_seconds=wall,
                sets_per_s=n_sets / wall, sync_seconds=sync_secs,
                sync_sum_seconds=sum(sync_secs), not_done_after_next=not_done,
                verdicts=verdicts, launches=counts)


SPIN_CYCLES = int(2e9)  # one spinning kernel of ~1 s at the H100's clocks


def spin_timed(torch, fn, spin=True):
    """fn() behind one spinning kernel on the stream (`torch.cuda._sleep`),
    or on an idle card: (its result, host ms until it returned, ms until
    the card was idle again)."""
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return out, (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def busy_card_dispatch(torch, api, P, batches, card):
    """Submits while the card is busy: one spinning kernel ahead of them
    on the stream, then one submit of each batch; a submit that waited on
    the card would take the spin's time. A pageable host-to-device copy
    under the same spin shows what such a wait looks like."""
    def timed(fn):
        return spin_timed(torch, fn)

    _, _, spin_ms = timed(lambda: None)
    _, pageable_ms, _ = timed(lambda: torch.zeros(1 << 16).to("cuda"))
    need(pageable_ms > spin_ms / 2,
         f"busy card: a pageable copy took {pageable_ms:.1f} ms under a "
         f"{spin_ms:.1f} ms spin (the spin does not hold the stream?)")
    out = dict(spin_ms=spin_ms, pageable_copy_ms=pageable_ms)
    P.configure(depth=2)
    for label in ("gossip", "aggregate"):
        sets = batches[label][0]
        fut, submit_ms, total_ms = timed(
            lambda: api.verify_signature_sets_async(sets, seed=70))
        need(fut.result(), f"busy card: {label} batch rejected")
        need(submit_ms < spin_ms / 4,
             f"busy card: submitting the {label} batch took {submit_ms:.1f} ms "
             f"under a {spin_ms:.1f} ms spin (dispatch waited on the card)")
        out[label] = dict(submit_ms=submit_ms, spin_and_verify_ms=total_ms)
    log(f"pipeline-busy: under a {spin_ms:.1f} ms spin a pageable copy took "
        f"{pageable_ms:.1f} ms of host time, a gossip submit "
        f"{out['gossip']['submit_ms']:.1f} ms, an aggregate submit "
        f"{out['aggregate']['submit_ms']:.1f} ms; card: {card}")
    return out


def scheduler_run(api, S, B, M, label, entries, lanes, seed0):
    """`entries` on `lanes` through the async api with continuous batching
    on: a fresh scheduler over a fresh depth-2 pipeline; returns the
    verdicts, the scheduler, the seconds, and the graphs captured and
    shape-registry misses it caused."""
    S.configure()
    graphs, misses = graph_count(B), M.TPU_COMPILE_CACHE_MISSES.value
    t0 = time.perf_counter()
    futs = [api.verify_signature_sets_async(sets, seed=seed0 + i, lane=lane, slot=7)
            for i, (sets, lane) in enumerate(zip(entries, lanes))]
    verdicts = [f.result() for f in futs]
    secs = time.perf_counter() - t0
    sched = S.default_scheduler()
    captured = graph_count(B) - graphs
    new_shapes = M.TPU_COMPILE_CACHE_MISSES.value - misses
    log(f"{label}: verdicts {verdicts}, {secs:.3f} s; launches "
        f"{sched.stats['launches']}, real sets {sched.stats['real_sets']}, padded "
        f"sets {sched.stats['pad_sets']}, merges {sched.stats['merges']}, merge "
        f"fallbacks {sched.stats['merge_fallbacks']}; launch log "
        f"{list(sched.launch_log)}; graphs captured {captured}, new shapes "
        f"{new_shapes}")
    return verdicts, sched, secs, captured, new_shapes


def phase_pipeline(torch, K, TP, B, api, batches, tagged, launches, card):
    """The asynchronous seam on the card: (a) a stream of STREAM_K batches
    through the pipeline, with host-packed keys and then with keys tagged
    into the 2^20-row table (when the table phase ran); (b) the
    continuous-batching scheduler merging four 16-set lanes into one
    launch padded to 64, honest and with one forged entry (the merge
    fallback); (c) the fallback backend over a primary that fails once."""
    from lighthouse_tpu_torch.crypto.bls import pipeline as P
    from lighthouse_tpu_torch.crypto.bls import scheduler as S
    from lighthouse_tpu_torch.crypto.bls.backends import fallback as FB
    from lighthouse_tpu_torch.resilience.primitives import CircuitBreaker, EventLog
    from lighthouse_tpu_torch.utils import metrics as M

    out = {}
    cold = [b for b in PIPELINE_BUCKETS
            if b + ((b[0],) if b[2] < b[0] else (0,)) not in B._seen_shape_buckets]
    if cold:
        report = B.warm_compile(buckets=cold)
        log(f"pipeline: warmed {[r['bucket'] for r in report]} in "
            f"{sum(r['seconds'] for r in report):.1f} s")
    gossip, forged_gossip, _ = batches["gossip"]
    aggregate, _, _ = batches["aggregate"]
    out["busy"] = busy_card_dispatch(torch, api, P, batches, card)

    def alternating(g, bad_g, a):
        # gossip, aggregate, gossip (forged), aggregate, ...
        return [((bad_g if i == 2 else g), 65) if i % 2 == 0 else (a, 33)
                for i in range(STREAM_K)]

    out["stream"] = pipeline_stream(
        torch, K, TP, api, P, "pipeline-stream",
        alternating(gossip, forged_gossip, aggregate), launches, card)
    if tagged:
        (t_gossip, t_forged), (t_aggregate, _) = tagged["gossip"], tagged["aggregate"]
        need(B.prepack_indices(t_gossip) is not None,
             "pipeline: table-tagged gossip batch has no index pack")
        out["stream_table"] = pipeline_stream(
            torch, K, TP, api, P, "pipeline-stream-table",
            alternating(t_gossip, t_forged, t_aggregate), launches, card)
    else:
        log("pipeline: table phase not run, no table-tagged stream")

    lanes = ("block", "aggregate", "unaggregated", "sync")
    q = len(gossip) // 4  # 16 sets an entry: natural bucket (16, 4, 16)
    entries = [gossip[q * i:q * (i + 1)] for i in range(4)]
    bad_entries = [forged_gossip[q * i:q * (i + 1)] for i in range(4)]
    try:
        with env_pinned(LIGHTHOUSE_TPU_CONT_BATCH="1"):
            P.configure(depth=2)
            verdicts, sched, secs, captured, new_shapes = scheduler_run(
                api, S, B, M, "pipeline-sched", entries, lanes, 80)
            need(verdicts == [True] * 4, f"pipeline-sched: verdicts {verdicts}")
            need(sched.stats["launches"] == 1 and sched.launch_log[0]["lanes"] == lanes,
                 f"pipeline-sched: launches {sched.stats}, log {list(sched.launch_log)}")
            need(captured == 0 and new_shapes == 0,
                 f"pipeline-sched: the merged launch captured {captured} graphs, "
                 f"{new_shapes} new shapes")
            out["sched"] = dict(seconds=secs, stats=dict(sched.stats),
                                captured=captured)
            unmerged = [api.verify_signature_sets(e, seed=90 + i)
                        for i, e in enumerate(bad_entries)]
            verdicts, sched, secs, captured, new_shapes = scheduler_run(
                api, S, B, M, "pipeline-sched-forged", bad_entries, lanes, 90)
            need(sched.stats["merge_fallbacks"] == 1,
                 f"pipeline-sched-forged: stats {sched.stats}")
            need(verdicts == unmerged == [True, False, True, True],
                 f"pipeline-sched-forged: verdicts {verdicts}, unmerged {unmerged}")
            need(captured == 0 and new_shapes == 0,
                 f"pipeline-sched-forged: {captured} graphs captured, {new_shapes} "
                 "new shapes (the re-verifies' natural bucket is warmed)")
            out["sched_forged"] = dict(seconds=secs, stats=dict(sched.stats),
                                       captured=captured)
    finally:
        S.configure()

    sets = parity_sets(api)[0]

    class FailsOnce:
        """torch_cuda, except that its first call raises."""

        calls = 0

        def verify_signature_sets(self, sets, seed=None, device=None):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("injected device fault")
            return B.verify_signature_sets(sets, seed=seed, device=device)

    want = B.verify_signature_sets(sets, seed=100)
    events = EventLog()
    fb = FB.configure(primary=FailsOnce(), events=events, breaker=CircuitBreaker(
        failure_threshold=1, denied_budget=2, half_open_probes=1,
        name="bls_primary", events=events))
    api.set_backend("fallback")
    try:
        before = M.BLS_FALLBACK_EVENTS.value
        names, oracle_secs = [], []
        for i in range(3):  # fault -> oracle, denied -> oracle, probe -> card
            t0 = time.perf_counter()
            got = api.verify_signature_sets(sets, seed=100)
            secs = time.perf_counter() - t0
            need(got == want, f"pipeline-fallback: call {i} verdict {got} != {want}")
            names.append(fb.active_backend_name())
            if i < 2:
                oracle_secs.append(secs)
        fallbacks = M.BLS_FALLBACK_EVENTS.value - before
    finally:
        api.set_backend("torch_cuda")
    need(fallbacks == 1, f"pipeline-fallback: bls_backend_fallback_total +{fallbacks}")
    need(names == ["cpu", "cpu", "torch_cuda"],
         f"pipeline-fallback: active backends {names}")
    log(f"pipeline-fallback: 4-set batch verdict {want} on the card and through "
        f"the fallback; bls_backend_fallback_total +{fallbacks:g}; active "
        f"{names}; cpu oracle {[round(x, 3) for x in oracle_secs]} s; events "
        f"{events.kinds()}")
    out["fallback"] = dict(verdict=want, active=names, oracle_seconds=oracle_secs,
                           events=events.kinds())
    return out


# --- the rest of crypto/bls: monolith, windowed ladder, correction, adversary --


def phase_monolith(torch, K, TP, B, CG, api, batches, launches, card, profile):
    """Each batch through the entry point under LIGHTHOUSE_TPU_MONOLITH=1:
    the first verify captures `verify_body` as one graph at the batch's
    set bucket, the counted one replays it (n_b + 1 Miller pairs); the
    forged batch; the eager monolith (plain `verify_body`); and the staged
    route's verdicts and warm replay time in the same run."""
    from lighthouse_tpu_torch.utils import metrics as M

    out = {}
    before = memory_line(torch)
    for label, (sets, forged, _) in batches.items():
        tag = f"monolith {label}"
        n_b = B._bucket(len(sets))
        pairs = n_b + 1
        staged = (api.verify_signature_sets(sets, seed=40),
                  api.verify_signature_sets(forged, seed=41))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        need(api.verify_signature_sets(sets, seed=42), f"{tag}: staged verify rejected")
        staged_secs = time.perf_counter() - t0
        mb = B._marshal_batch(sets, "cuda", seed=46)
        key = CG.shape_key((mb.u[mb.h_idx], mb.pk, mb.sig, mb.scalars, mb.real))
        with env_pinned(LIGHTHOUSE_TPU_MONOLITH="1"):
            t0 = time.perf_counter()
            need(api.verify_signature_sets(sets, seed=43), f"{tag}: first verify rejected")
            first_secs = time.perf_counter() - t0
            K.reset_launches()
            t0 = time.perf_counter()
            ok = api.verify_signature_sets(sets, seed=44)
            secs = time.perf_counter() - t0
            counts = dict(K.LAUNCHES)
            need(M.BLS_MILLER_PAIRS_LAST.value == pairs,
                 f"{tag}: {M.BLS_MILLER_PAIRS_LAST.value} Miller pairs counted, want {pairs}")
            t0 = time.perf_counter()
            bad = api.verify_signature_sets(forged, seed=45)
            bad_secs = time.perf_counter() - t0
        need(ok, f"{tag}: honest batch rejected on replay")
        need(not bad, f"{tag}: forged batch accepted on replay")
        need(staged == (ok, bad), f"{tag}: staged verdicts {staged}, monolith {(ok, bad)}")
        check_launches(tag, counts, expected_launches(TP, pairs))
        add_launches(launches, counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_ok = bool(B.run_marshalled(mb, timer=eager_stages, monolith=True))
        eager_secs = time.perf_counter() - t0
        eager_bad = bool(B.run_marshalled(B._marshal_batch(forged, "cuda", seed=46),
                                          timer=eager_stages, monolith=True))
        need(eager_ok and not eager_bad,
             f"{tag}: eager monolith verdicts {(eager_ok, eager_bad)}")
        capture = B._monolith_graphs.capture_seconds.get(key)
        need(capture is not None, f"{tag}: no monolith graph at {key}")
        # host ms until a replayed verify is enqueued (nothing inside reads
        # the card), and its wall to the end of the device work
        enqueue = {}
        for route, mono in (("staged", False), ("monolith", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            B.run_marshalled(mb, monolith=mono)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue[route] = dict(enqueue_ms=(t1 - t0) * 1e3,
                                  wall_ms=(time.perf_counter() - t0) * 1e3)
        log(f"{tag}: host ms to enqueue one replayed verify / its wall: " + ", ".join(
            f"{r} {v['enqueue_ms']:.1f} / {v['wall_ms']:.1f}" for r, v in enqueue.items()))
        log(f"{tag}: {len(sets)} sets, n_b {n_b}, {pairs} Miller pairs; honest True, "
            f"forged False (replayed and eager), staged verdicts equal; first verify "
            f"{first_secs:.3f} s (eager run + capture {capture:.3f} s), replay "
            f"{secs:.3f} s ({len(sets) / secs:.2f} sets/s), forged {bad_secs:.3f} s, "
            f"eager {eager_secs:.3f} s; staged replay {staged_secs:.3f} s in this "
            f"run; launches {counts}; card: {card}")
        out[label] = dict(sets=len(sets), pairs=pairs, first_seconds=first_secs,
                          capture_seconds=capture, seconds=secs,
                          forged_seconds=bad_secs, eager_seconds=eager_secs,
                          staged_seconds=staged_secs, enqueue=enqueue,
                          launches=counts)
        if profile:
            out[label]["profile"] = profile_verify(torch, K, B, sets, tag, monolith=True)
    after = memory_line(torch)
    log(f"monolith: graph pools {mib(before['graph_pools'])} -> "
        f"{mib(after['graph_pools'])}, reserved {mib(before['reserved'])} -> "
        f"{mib(after['reserved'])}; card: {card}")
    out["memory_before"], out["memory_after"] = before, after
    return out


def phase_windowed(card, launches):
    """The windowed phase: this script again, in a child process with
    LIGHTHOUSE_TPU_PALLAS=1 and the phases build,windowed-child. Its
    output is relayed line by line; its paths line carries its launches."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phases", "build,windowed-child"],
        env=dict(os.environ, LIGHTHOUSE_TPU_PALLAS="1"), capture_output=True,
        text=True, timeout=900,
    )
    secs = time.perf_counter() - t0
    child = None
    for line in proc.stdout.splitlines():
        log(f"windowed-child | {line}")
        if line.startswith('{"paths"'):
            child = json.loads(line)["paths"].get("windowed-child")
    for line in proc.stderr.splitlines()[-30:]:
        log(f"windowed-child stderr | {line}")
    need(proc.returncode == 0, f"windowed: the child exited {proc.returncode}")
    need(child is not None, "windowed: the child printed no windowed-child result")
    for label in ("gossip", "aggregate"):
        add_launches(launches, child[label]["launches"])
    log(f"windowed: the child passed in {secs:.1f} s; card: {card}")
    return dict(child, seconds=secs)


def with_ladder(C, stage, ladder):
    """`stage` run with `ladder` bound as curve.scalar_mul_u64 (the stage
    reads it at call time; a graph of this function keeps the ladder it
    was captured with)."""
    def run(*args):
        saved = C.scalar_mul_u64
        C.scalar_mul_u64 = ladder
        try:
            return stage(*args)
        finally:
            C.scalar_mul_u64 = saved
    return run


def replay_ms(torch, fn, args, reps=5) -> float:
    """The median of `reps` synchronized calls of `fn`, ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_windowed_child(torch, K, TP, B, CG, api, batches, launches, card):
    """In a process started with LIGHTHOUSE_TPU_PALLAS=1: the entry point
    runs the windowed ladder; its prep is held to the bit ladder's by
    canon equality, the ladder on the card to its plain version on the
    CPU, and the verdicts to the staged ones (True, False)."""
    from lighthouse_tpu_torch.crypto.bls.gpu import curve as C
    from lighthouse_tpu_torch.crypto.bls.gpu import limbs as L

    need(C.WINDOWED_LADDER and C.scalar_mul_u64 is not C._scalar_mul_u64_bit,
         "windowed-child: LIGHTHOUSE_TPU_PALLAS=1 did not select the windowed ladder")
    bit_graphs = CG.graphed(with_ladder(C, B._stage_prep, C._scalar_mul_u64_bit))
    out = {}
    for label, (sets, forged, pairs) in batches.items():
        tag = f"windowed {label}"
        t0 = time.perf_counter()
        need(api.verify_signature_sets(sets, seed=10), f"{tag}: first verify rejected")
        first_secs = time.perf_counter() - t0
        K.reset_launches()
        t0 = time.perf_counter()
        ok = api.verify_signature_sets(sets, seed=11)
        secs = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        need(ok, f"{tag}: honest batch rejected")
        check_launches(tag, counts, expected_launches(TP, pairs))
        add_launches(launches, counts)
        need(not api.verify_signature_sets(forged, seed=13), f"{tag}: forged batch accepted")
        mb = B._marshal_batch(sets, "cuda", seed=12)
        args = (mb.pk, mb.sig, mb.scalars, mb.real)
        win = B._prep_graphs(*args)  # replays the windowed capture
        t0 = time.perf_counter()
        bit = bit_graphs(*args)  # eager run + capture with the bit ladder
        bit_capture = time.perf_counter() - t0
        for g, w in zip(win, B._stage_prep(*args)):
            need(torch.equal(g, w), f"{tag}: windowed prep replay differs from its eager run")
        rpk_w, rinf_w, ssum_w, sinf_w, ok_w = win
        rpk_b, rinf_b, ssum_b, sinf_b, ok_b = bit
        need(torch.equal(rinf_w, rinf_b) and torch.equal(sinf_w, sinf_b)
             and torch.equal(ok_w, ok_b) and bool(ok_w),
             f"{tag}: infinity masks or flags differ between the ladders")
        need(torch.equal(L.canon(rpk_w), L.canon(rpk_b))
             and torch.equal(L.canon(ssum_w), L.canon(ssum_b)),
             f"{tag}: windowed and bit-ladder prep give other affine points")
        need(not torch.equal(rpk_w, rpk_b) or not torch.equal(ssum_w, ssum_b),
             f"{tag}: the two ladders gave the same limbs (not two ladders?)")
        s = mb.scalars[:4].clone()
        s[0] = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF], device=s.device)
        for F, p in ((C.FP, mb.pk[:4, 0]), (C.FP2, mb.sig[:4])):
            card_out = C.scalar_mul_u64_windowed(p, s, F)
            need(torch.equal(card_out.cpu(), C.scalar_mul_u64_windowed(p.cpu(), s.cpu(), F)),
                 f"{tag}: windowed ladder on the card differs from its plain version "
                 f"on the CPU ({F.__name__})")
        win_ms = replay_ms(torch, B._prep_graphs, args)
        bit_ms = replay_ms(torch, bit_graphs, args)
        log(f"{tag}: windowed ladder (switch read at import); honest True, forged "
            f"False; prep canon-equal to the bit ladder's; the ladder bit-identical "
            f"card vs CPU at 4 rows, G1 and G2; first verify {first_secs:.3f} s, "
            f"replay {secs:.3f} s; prep replay ms (median of 5, synchronized): "
            f"windowed {win_ms:.2f}, bit {bit_ms:.2f} (bit capture {bit_capture:.3f} s); "
            f"launches {counts}; card: {card}")
        out[label] = dict(first_seconds=first_secs, seconds=secs, prep_ms_windowed=win_ms,
                          prep_ms_bit=bit_ms, launches=counts)
    return out


def committee_points(api, C, n, base_scalar):
    """n distinct G1 keys [base_scalar * j]G, j = 1..n, by host additions."""
    base = C.g1_generator().mul(base_scalar)
    acc, out = base, []
    for _ in range(n):
        out.append(api.PublicKey(acc, subgroup_checked=True))
        acc = acc + base
    return out


def phase_correct(torch, K, B, api, launches, card):
    """The speculation correction at a mainnet epoch's size: the
    committee-aggregate table on the card, and the device correction of a
    512-member committee's aggregate for 1, 7 and 33 absent members."""
    from lighthouse_tpu_torch.crypto.bls import curve_ref as C
    from lighthouse_tpu_torch.utils import metrics as M

    aggregates = committee_points(api, C, 64 * 32, 7)
    t0 = time.perf_counter()
    B.set_committee_aggregates(aggregates)
    table = B.committee_table().device_table()
    torch.cuda.synchronize()
    table_ms = (time.perf_counter() - t0) * 1e3
    need(tuple(table.shape) == (2048, 3, W) and table.device.type == "cuda",
         f"correct: committee table {tuple(table.shape)} on {table.device}")
    need(M.SPECULATE_TABLE_BYTES.value == 2048 * 3 * W * 4,
         f"correct: SPECULATE_TABLE_BYTES {M.SPECULATE_TABLE_BYTES.value}")
    members = committee_points(api, C, 512, 11)
    full = members[0].point
    for m in members[1:]:
        full = full + m.point
    full_pk = api.PublicKey(full, subgroup_checked=True)
    out = dict(table_rows=2048, table_ms=table_ms)
    for k in (1, 7, 33):
        absent = members[5::15][:k]
        gone = {id(m) for m in absent}
        want = None
        for m in members:
            if id(m) not in gone:
                want = m.point if want is None else want + m.point
        t0 = time.perf_counter()
        first = B.correct_aggregate_device(full_pk, absent)
        first_ms = (time.perf_counter() - t0) * 1e3
        K.reset_launches()
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            got = B.correct_aggregate_device(full_pk, absent)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        counts = dict(K.LAUNCHES)
        for g in (first, got):
            need(g is not None and (g.x.n, g.y.n) == (want.x.n, want.y.n),
                 f"correct: {k} absent: device correction != host aggregate")
        need(counts["fp_mul"] > 0 and counts["fp_sq"] > 0,
             f"correct: {k} absent: the field kernels did not launch: {counts}")
        add_launches(launches, {n: c // reps for n, c in counts.items()})
        log(f"correct: 512-member committee, {k} absent (bucket {B._bucket(k)}): equal "
            f"to the host aggregate of the present members; {ms:.3f} ms a call "
            f"(replayed, with its host read; mean of {reps}), first call "
            f"{first_ms:.1f} ms (eager run + capture); launches a call "
            f"{ {n: c // reps for n, c in counts.items() if c} }; card: {card}")
        out[f"absent_{k}"] = dict(ms=ms, first_ms=first_ms)
    log(f"correct: committee table of 2048 aggregates on the card in {table_ms:.1f} ms "
        f"({2048 * 3 * W * 4} bytes)")
    return out


def _host_paths(sets, seed, paths):
    """Worker: `adversary.run_path` of each of `paths` on `sets` (the paths
    that run on the host only: the cpu oracle, the fallback over a primary
    that fails)."""
    from lighthouse_tpu_torch.crypto.bls import adversary as A

    return {p: A.run_path(p, sets, seed=seed) for p in paths}


ADVERSARY_PATHS = ("cpu", "torch_per_set", "torch_aggregated", "fallback")
HOST_PATHS = ("cpu", "fallback")  # run on the host pool, beside the card's


def phase_adversary(torch, K, TP, B, api, launches, card, pool):
    """The adversary matrix on the card: every probe batch (seed 0) and two
    honest controls through the cpu, torch_per_set, torch_aggregated and
    fallback paths and the monolith; the subgroup family through the
    PubkeyTable route too. The host-only paths (`HOST_PATHS`: pure-Python
    pairings, ~1 s a batch each) run on the host pool from the phase's
    start, beside the captures and the card's paths."""
    from lighthouse_tpu_torch.crypto.bls import adversary as A

    t0 = time.perf_counter()
    batches = {"honest": A.honest_sets(0),
               "honest-grid": A.honest_sets(0, n_sets=6, n_messages=2)}
    for family in sorted(A.BATCHES):
        for bi, batch in enumerate(A.BATCHES[family](0)):
            batches[f"{family}[{bi}]"] = batch
    host_rows = {label: pool.submit(_host_paths, sets, 11, HOST_PATHS)
                 for label, sets in batches.items()}
    build_secs = time.perf_counter() - t0
    buckets = set()
    for sets in batches.values():
        mb = B._marshal_batch(sets, "cuda", seed=11)
        if mb is not None:
            buckets.add(tuple(B._shape_bucket(mb)[:3]))
    capture = {}
    for agg in ("0", "1"):
        with env_pinned(LIGHTHOUSE_TPU_MSG_AGG=agg):
            for r in B.warm_compile(buckets=sorted(buckets)):
                capture[f"MSG_AGG={agg} {r['bucket']}"] = r["seconds"]
    with env_pinned(LIGHTHOUSE_TPU_MONOLITH="1"):
        for label in ("honest", "honest-grid"):
            t1 = time.perf_counter()
            need(A.run_path("torch_aggregated", batches[label], seed=11),
                 f"adversary: {label} rejected by the monolith")
            capture[f"monolith {label}"] = time.perf_counter() - t1
    log(f"adversary: {len(batches)} batches built in {build_secs:.1f} s; buckets "
        f"{sorted(buckets)}; capture s " + ", ".join(
            f"{k} {v:.2f}" for k, v in capture.items()))
    card_paths = tuple(p for p in ADVERSARY_PATHS if p not in HOST_PATHS)
    matrix, secs = {}, {}
    K.reset_launches()
    t0 = time.perf_counter()
    for label, sets in batches.items():
        t1 = time.perf_counter()
        row = {**host_rows[label].result(),
               **A.rejection_matrix(sets, seed=11, paths=card_paths)}
        row = {p: row[p] for p in ADVERSARY_PATHS}
        with env_pinned(LIGHTHOUSE_TPU_MONOLITH="1"):
            row["monolith"] = A.run_path("torch_aggregated", sets, seed=11)
        if label.startswith("subgroup"):
            row["table"] = table_route(B, api, sets)
        secs[label] = time.perf_counter() - t1
        matrix[label] = row
        log(f"adversary: {label:26s} " + " ".join(
            f"{p}={'accept' if v else 'reject'}" for p, v in row.items())
            + f" ({secs[label]:.2f} s)")
    counts = dict(K.LAUNCHES)
    total = time.perf_counter() - t0
    for label, row in matrix.items():
        want = label.startswith("honest")
        need(all(v is want for v in row.values()),
             f"adversary: {label}: {row} (want every path {want})")
    check_launches("adversary", counts, {})
    add_launches(launches, counts)
    log(f"adversary: every probe rejected and every control accepted on every path "
        f"({len(matrix)} batches, {total:.1f} s); launches {counts}; card: {card}")
    return dict(matrix=matrix, seconds=secs, capture_seconds=capture,
                build_seconds=build_secs, launches=counts)


def table_route(B, api, sets) -> bool:
    """A batch through the PubkeyTable route: its keys imported into a
    fresh table on the card (the import is a key_validate seam: a refusal
    is a rejection), then verified by index."""
    keys = [k for s in sets for k in s.pubkeys]
    table = B.PubkeyTable("cuda")
    try:
        table.import_new_pubkeys(keys)
    except api.BlsError:
        return False
    offsets = [0]
    for s in sets:
        offsets.append(offsets[-1] + len(s.pubkeys))
    tagged = tag_sets(api, sets, table, lambda i, j, key: offsets[i] + j)
    return bool(B.verify_signature_sets(tagged, seed=11))


def gossip_sets(api):
    """64 single-pubkey sets over 64 distinct messages, plus a forged copy
    with one signature over the wrong message."""
    sks = [api.SecretKey(100003 + 7919 * i) for i in range(64)]
    msgs = [b"gossip-attestation-%02d" % i for i in range(64)]
    sets = [api.SignatureSet.single_pubkey(sk.sign(m), sk.public_key(), m)
            for sk, m in zip(sks, msgs)]
    forged = list(sets)
    forged[17] = api.SignatureSet.single_pubkey(
        sks[17].sign(b"not the attested data"), sks[17].public_key(), msgs[17])
    return sets, forged


def aggregate_sets(api):
    """1024 sets x 2 pubkeys over 32 messages, tiled from 32 signed sets;
    the forged copy carries one set's signature under another message."""
    base = []
    for j in range(32):
        a, b = api.SecretKey(500009 + 2 * j), api.SecretKey(500010 + 2 * j)
        m = b"aggregate-data-%02d" % j
        sig = api.AggregateSignature.aggregate([a.sign(m), b.sign(m)]).to_signature()
        base.append(api.SignatureSet.multiple_pubkeys(
            sig, [a.public_key(), b.public_key()], m))
    sets = [base[i % 32] for i in range(1024)]
    forged = list(sets)
    forged[500] = api.SignatureSet.multiple_pubkeys(
        base[3].signature, base[500 % 32].pubkeys, base[500 % 32].message)
    return sets, forged


# --- the beacon chain's signature-verification consumers (block, attestations)


BLOCK_VALIDATORS = 16384  # 16384 // 32 // 128 = 4 committees of 128 a slot
BLOCK_DISTINCT_KEYS = 1024  # the registry is tiled from this many interop keys
BLOCK_SLOT = 31  # the last slot of epoch 0: slots 0-30 have 124 committees
GOSSIP_UNAGGREGATED = 64  # the beacon processor's gossip batch
GOSSIP_AGGREGATES = 32
# one forged item a batch: the aggregates' 3-forgery run (25-30 s on the
# card, its 17 bisection calls) was cut with the sync phase's once the
# genesis and finality phases came, and the unaggregated batch's (6.4 s,
# 20 bisection calls) once the scenario phase came, to keep the default run
# under ~840 s
FORGED_UNAGGREGATED = ((17,),)
FORGED_AGGREGATES = ((11,),)


def consensus_modules():
    """The port's consensus modules that the block, attestations, chain,
    sync, pool, genesis, finality, merge and network phases drive, as one
    namespace."""
    import importlib
    from types import SimpleNamespace

    names = dict(
        ssz="ssz", types="types", helpers="types.helpers",
        per_slot="state_transition.per_slot", context="state_transition.context",
        bsv="state_transition.block_signature_verifier",
        pubkey_cache="chain.pubkey_cache", att="chain.attestation_verification",
        observed="pool.observed", processor="processor", api="crypto.bls.api",
        curve="crypto.bls.curve_ref", fields="crypto.bls.fields_ref",
        metrics="utils.metrics", tracing="utils.tracing",
        per_block="state_transition.per_block", per_epoch="state_transition.per_epoch",
        beacon_chain="chain.beacon_chain", bv="chain.block_verification",
        hot_cold="store.hot_cold", kv="store.kv", containers="types.containers",
        sync="chain.sync_committee_verification", monitor="chain.validator_monitor",
        light="chain.light_client", pool="pool", speculate="speculate",
        reprocess="processor.reprocess", adversary="crypto.bls.adversary",
        genesis="state_transition.genesis", deposit_tree="eth1.deposit_tree",
        signature_sets="state_transition.signature_sets", ef_tests="ef_tests",
        snappy="network.snappy", harness="harness", native_kv="store.native_kv",
        fsck="store.fsck", execution_layer="execution_layer",
        builder="execution_layer.builder", eth1="eth1",
        beacon_node="validator_client.beacon_node", network="network",
        net_node="network.node", net_sync="network.sync", wire="network.wire",
        secure="network.secure", discovery="network.discovery", slasher="slasher",
        vc="validator_client", http_api="http_api", serving="serving",
        keystore="crypto.keystore",
    )
    return SimpleNamespace(**{
        k: importlib.import_module("lighthouse_tpu_torch." + v)
        for k, v in names.items()})


# The block and attestations phases' pure-Python crypto (interop keys,
# signatures, the cpu oracle) costs minutes of one host core; on a host
# pool it runs on the machine's cores. Worker functions take and return
# plain ints and bytes.


def host_pool():
    """Worker processes for the phases' host crypto: spawned (no card
    state reaches them; the port's oracle modules import no torch), shut
    down by the caller (`with`)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, min(8, os.cpu_count() or 1)),
        mp_context=multiprocessing.get_context("spawn"))


def _pubkey_xy(index):
    """Worker: the affine coordinates of interop key `index`."""
    from lighthouse_tpu_torch.types import interop_keypair

    p = interop_keypair(index)[1].point
    return p.x.n, p.y.n


def _validated_xy(data):
    """Worker: the affine coordinates of the public key `data`, after the
    port's decompression and subgroup check (`PublicKey.from_bytes`)."""
    from lighthouse_tpu_torch.crypto.bls import api

    p = api.PublicKey.from_bytes(data).point
    return p.x.n, p.y.n


def _sign(scalar, root):
    """Worker: the signature of secret `scalar` (mod r) over `root`."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.constants import R

    return api.SecretKey(scalar % R).sign(root).to_bytes()


def _oracle(sets, seed):
    """Worker: the cpu oracle backend's verdict on sets given as
    ([(x, y) of each key], message, signature bytes); the keys are the
    caller's validated ones."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.backends import cpu
    from lighthouse_tpu_torch.crypto.bls.curve_ref import Point
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    keys = {}

    def key(xy):
        if xy not in keys:
            keys[xy] = api.PublicKey(Point(Fp(xy[0]), Fp(xy[1])), subgroup_checked=True)
        return keys[xy]

    return cpu.verify_signature_sets([
        api.SignatureSet.multiple_pubkeys(
            api.Signature.from_bytes(sig), [key(xy) for xy in pks], msg)
        for pks, msg, sig in sets], seed=seed)


def _oracle_aggregate(signature, keys, messages):
    """Worker: the cpu oracle backend's aggregate_verify over keys given
    as (x, y) (the caller's validated ones)."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.backends import cpu
    from lighthouse_tpu_torch.crypto.bls.curve_ref import Point
    from lighthouse_tpu_torch.crypto.bls.fields_ref import Fp

    return cpu.aggregate_verify(
        api.Signature.from_bytes(signature),
        [api.PublicKey(Point(Fp(x), Fp(y)), subgroup_checked=True) for x, y in keys],
        messages)


def oracle_job(sets):
    """Sets in `_oracle`'s plain form."""
    return [([(k.point.x.n, k.point.y.n) for k in s.pubkeys], bytes(s.message),
             s.signature.to_bytes()) for s in sets]


class HostCrypto:
    """The phases' host crypto: signatures made a pass at a time, interop
    keys, the cpu oracle's verdicts; on the host pool when there is one,
    else in this process. Signatures are memoized on (scalar, root): under
    the tiled registry many validators hold one key, and their signatures
    over one root repeat."""

    def __init__(self, pool=None):
        self.pool = pool
        self._signed = {}
        self._oracled = {}

    def sign(self, jobs):
        """[(secret scalars, root)] -> [signature bytes], each made once
        from its scalars summed mod r (the aggregate of their
        signatures)."""
        args = [(sum(scalars), bytes(root)) for scalars, root in jobs]
        todo = list(dict.fromkeys(a for a in args if a not in self._signed))
        if todo:
            sigs = ([_sign(k, r) for k, r in todo] if self.pool is None
                    else self.pool.map(_sign, *zip(*todo)))
            self._signed.update(zip(todo, sigs))
        return [self._signed[a] for a in args]

    def map(self, fn, items):
        return list(map(fn, items) if self.pool is None else self.pool.map(fn, items))

    def _submit(self, fn, *args):
        """fn(*args) on the pool, once for equal arguments (a batch met
        again, as genesis meets its deposits, is not verified again):
        a callable that returns its result."""
        key = (fn.__name__, hashlib.sha256(repr(args).encode()).digest())
        if key not in self._oracled:
            if self.pool is None:
                result = fn(*args)
                self._oracled[key] = lambda: result
            else:
                self._oracled[key] = self.pool.submit(fn, *args).result
        return self._oracled[key]

    def oracle(self, batches, seed):
        """A callable that returns the cpu oracle backend's verdict on each
        batch of sets: computed on the pool meanwhile, else when called."""
        results = [self._submit(_oracle, oracle_job(sets), seed) for sets in batches]
        return lambda: [r() for r in results]

    def oracle_aggregate(self, signature, pubkeys, messages):
        """As `oracle`, for one aggregate_verify."""
        return self._submit(
            _oracle_aggregate, signature.to_bytes(),
            [(k.point.x.n, k.point.y.n) for k in pubkeys], [bytes(m) for m in messages])


def prevalidate_pubkeys(C, host, state, checked_xy=None):
    """The pubkey cache's decompression and subgroup check of each distinct
    key of `state` (~24 ms of host Python a key), made by the same
    `PublicKey.from_bytes` on the host pool (or given, as `checked_xy`:
    the (x, y) it gave each key's bytes) and handed to the cache's
    process-wide memo (`pubkey_cache._validated`), which every chain built
    on the registry reads. Returns the keys' count."""
    from types import SimpleNamespace

    PC = C.pubkey_cache
    distinct = list(dict.fromkeys(bytes(v.pubkey) for v in state.validators))
    if checked_xy is None:
        checked_xy = dict(zip(distinct, host.map(_validated_xy, distinct)))
    checked = {
        b: C.api.PublicKey(C.curve.Point(C.fields.Fp(x), C.fields.Fp(y)), b,
                           subgroup_checked=True)
        for b, (x, y) in ((b, checked_xy[b]) for b in distinct)}
    real = PC.PublicKey
    PC.PublicKey = SimpleNamespace(from_bytes=checked.__getitem__)
    try:
        for b in distinct:
            PC._validated(b)
    finally:
        PC.PublicKey = real
    return len(distinct)


def registry_state(C, preset, spec, validators, distinct, host):
    """The port's interop_genesis_state of `validators` validators whose
    keys are tiled from `distinct` interop keys: validator i holds interop
    key i % distinct (interop_keypair is swapped for the call, the keys
    made by `host`). Returns (state, secret_of), secret_of(i)
    the scalar of validator i's key."""
    I = C.types.interop
    keys = [C.api.PublicKey(C.curve.Point(C.fields.Fp(x), C.fields.Fp(y)),
                            subgroup_checked=True)
            for x, y in host.map(_pubkey_xy, range(distinct))]
    keypair = I.interop_keypair
    I.interop_keypair = lambda i: (I.interop_secret_key(i % distinct), keys[i % distinct])
    try:
        state = I.interop_genesis_state(validators, preset, spec)
    finally:
        I.interop_keypair = keypair
    return state, tiled_secret_of(C, distinct)


def tiled_secret_of(C, distinct):
    """secret_of(i): the scalar of validator i's key in a registry tiled
    from `distinct` interop keys."""

    def secret_of(i):
        return C.types.interop_secret_key(i % distinct).scalar

    return secret_of


def registry_spec(C):
    """The registry's preset and spec: MAINNET, altair at epoch 0."""
    return C.types.MAINNET, C.types.ChainSpec.interop(altair_fork_epoch=0)


def _registry_genesis(validators, distinct):
    """Worker: `registry_state`'s genesis of `validators` validators tiled
    from `distinct` keys (`registry_spec`), its keys made here: (fork, SSZ
    bytes), its seconds, and the (x, y) that the port's decompression and
    subgroup check (`PublicKey.from_bytes`) give each distinct key's bytes
    (`prevalidate_pubkeys`'s `checked_xy`)."""
    C = consensus_modules()
    t = time.perf_counter()
    state, _ = registry_state(C, *registry_spec(C), validators, distinct, HostCrypto())
    secs = time.perf_counter() - t
    distinct_keys = dict.fromkeys(bytes(v.pubkey) for v in state.validators)
    checked_xy = {b: _validated_xy(b) for b in distinct_keys}
    return state.fork_name, state.as_ssz_bytes(), secs, checked_xy


def state_from_ssz(C, preset, fork, data):
    return C.types.state_class_for(C.types.types_for(preset), fork).from_ssz_bytes(data)


def attestation_data(C, state, slot, index, preset):
    """AttestationData for (slot, committee index) as seen from `state`
    (past `slot`), as the chain's attesters build it."""
    H = C.helpers
    epoch = slot // preset.slots_per_epoch
    head = H.get_block_root_at_slot(state, slot, preset)
    target_slot = epoch * preset.slots_per_epoch
    target = (H.get_block_root_at_slot(state, target_slot, preset)
              if target_slot < state.slot else head)
    source = (state.current_justified_checkpoint
              if epoch == state.slot // preset.slots_per_epoch
              else state.previous_justified_checkpoint)
    return C.types.AttestationData(
        slot=slot, index=index, beacon_block_root=head, source=source,
        target=C.types.Checkpoint(epoch=epoch, root=target))


def attester_root(C, state, data, preset):
    domain = C.types.get_domain(
        state, C.types.DOMAIN_BEACON_ATTESTER, data.target.epoch, preset)
    return C.types.compute_signing_root(data, domain)


def wrong_root(root):
    return bytes(b ^ 0xFF for b in root)


def produce_block(C, state, preset, spec, secret_of, host, forge=None, attest=True,
                  forge_proposal=False, attestations=None, sync_aggregate=None,
                  payload=None):
    """One signed block of `state`'s fork (altair; bellatrix with
    `payload`, its execution payload) at `state.slot` (slot processing
    done) and its post-state: an attestation of every committee of the slots it
    may include (the inclusion window, at most MAX_ATTESTATIONS), all bits
    set; one more aggregate of each committee of the last slot over
    another bit subset (its member k dropped), as blocks do carry, while
    room is left; a full sync aggregate; the randao reveal; the state
    root, from the block applied to a copy of `state` without signature
    checks, as a proposer computes it; and the proposal signature.
    `forge` = k signs attestation k over a wrong root, `attest=False`
    leaves the attestations out, and `forge_proposal` signs the proposal
    over a wrong root. `attestations` (signed, as an operation pool packs
    them) and `sync_aggregate` (as a contribution pool makes it) take the
    place of the ones it would make."""
    T = C.types
    t = T.types_for(preset)
    slot, spe = state.slot, preset.slots_per_epoch
    epoch = slot // spe
    ctxt = C.context.ConsensusContext(preset, spec)
    atts, jobs = [], []
    if attestations is not None:
        atts, attest = list(attestations), False

    def attest_(s, index, committee, bits):
        data = attestation_data(C, state, s, index, preset)
        atts.append(t.Attestation(aggregation_bits=bits, data=data))
        root = attester_root(C, state, data, preset)
        jobs.append(([secret_of(v) for v, b in zip(committee, bits) if b],
                     wrong_root(root) if len(jobs) == forge else root))

    for s in range(max(0, slot - spe), slot) if attest else ():
        cache = ctxt.committee_cache(state, s // spe)
        for index, committee in enumerate(cache.get_all_committees_at_slot(s)):
            attest_(s, index, committee, tuple(True for _ in committee))
    last = slot - 1
    cache = ctxt.committee_cache(state, last // spe)
    for index, committee in enumerate(cache.get_all_committees_at_slot(last)):
        if not attest or len(atts) >= preset.max_attestations:
            break
        k = index % len(committee)
        attest_(last, index, committee, tuple(i != k for i in range(len(committee))))
    del atts[preset.max_attestations:], jobs[preset.max_attestations:]
    signed_here = len(jobs)

    parent_root = state.latest_block_header.tree_hash_root()
    if sync_aggregate is None:
        first = {}
        for i, v in enumerate(state.validators):
            first.setdefault(bytes(v.pubkey), i)
        members = [first[bytes(pk)] for pk in state.current_sync_committee.pubkeys]
        sync_domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE,
                                   max(slot - 1, 0) // spe, preset)
        jobs.append(([secret_of(m) for m in members], T.SigningData(
            object_root=parent_root, domain=sync_domain).tree_hash_root()))
    proposer = C.per_slot.get_beacon_proposer_index(state, preset, spec)
    jobs.append(([secret_of(proposer)], T.SigningData(
        object_root=C.ssz.uint64.hash_tree_root(epoch),
        domain=T.get_domain(state, T.DOMAIN_RANDAO, epoch, preset)).tree_hash_root()))
    sigs = host.sign(jobs)
    for att, sig in zip(atts[:signed_here], sigs):
        att.signature = sig
    if sync_aggregate is None:
        sync_aggregate = t.SyncAggregate(
            sync_committee_bits=tuple(True for _ in members),
            sync_committee_signature=sigs[-2])
    block_cls, signed_cls, body_cls = C.containers.block_classes_for(t, state.fork_name)
    body = body_cls(
        randao_reveal=sigs[-1], eth1_data=state.eth1_data, attestations=tuple(atts),
        sync_aggregate=sync_aggregate,
        **({} if payload is None else dict(execution_payload=payload)))
    block = block_cls(slot=slot, proposer_index=proposer, parent_root=parent_root,
                      state_root=bytes(32), body=body)
    post = C.per_slot.clone_state(state)
    C.per_block.per_block_processing(
        post, signed_cls(message=block),
        preset, spec, strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION,
        verified_proposer_index=proposer)
    block.state_root = C.ssz.cached_root(post)
    domain = T.get_domain(state, T.DOMAIN_BEACON_PROPOSER, epoch, preset)
    root = T.compute_signing_root(block, domain)
    signature, = host.sign([([secret_of(proposer)],
                               wrong_root(root) if forge_proposal else root)])
    return signed_cls(message=block, signature=signature), post


def forge_attestation(C, state, preset, spec, secret_of, block, k, host):
    """A copy of `block` whose attestation k is signed by its members over
    a wrong root."""
    forged = type(block).from_ssz_bytes(block.as_ssz_bytes())
    atts = list(forged.message.body.attestations)
    ctxt = C.context.ConsensusContext(preset, spec)
    members = ctxt.get_indexed_attestation(state, atts[k]).attesting_indices
    root = attester_root(C, state, atts[k].data, preset)
    atts[k].signature, = host.sign([([secret_of(v) for v in members],
                                       wrong_root(root))])
    forged.message.body.attestations = tuple(atts)
    return forged


def block_key_count(sets) -> int:
    return sum(len(s.pubkeys) for s in sets)


def untagged(C, sets):
    """The sets with every pubkey replaced by an untagged copy of the same
    validated point: the host-packed route's batch."""
    return [C.api.SignatureSet.multiple_pubkeys(
        s.signature, [C.api.PublicKey(k.point, k.to_bytes(), subgroup_checked=True)
                      for k in s.pubkeys], s.message) for s in sets]


def gossip_unaggregated(C, state, preset, spec, secret_of, slot, n, host):
    """n single-bit attestations at `slot` from n distinct attesters, taken
    round robin over the slot's committees (position 0 of each, then 1,
    ...)."""
    t = C.types.types_for(preset)
    cache = C.context.ConsensusContext(preset, spec).committee_cache(
        state, slot // preset.slots_per_epoch)
    committees = cache.get_all_committees_at_slot(slot)
    datas = [attestation_data(C, state, slot, i, preset) for i in range(len(committees))]
    out, jobs = [], []
    for pos in range(max(len(c) for c in committees)):
        for index, committee in enumerate(committees):
            if len(out) == n or pos >= len(committee):
                continue
            out.append(t.Attestation(
                aggregation_bits=tuple(i == pos for i in range(len(committee))),
                data=datas[index]))
            jobs.append(([secret_of(committee[pos])],
                         attester_root(C, state, datas[index], preset)))
    need(len(out) == n, f"gossip: {len(out)} of {n} unaggregated attestations")
    for att, sig in zip(out, host.sign(jobs)):
        att.signature = sig
    return out


SELECTION_CHUNK = 16  # selection proofs signed at once while seeking aggregators


def gossip_aggregates(C, state, preset, spec, secret_of, n, host, per_committee=2):
    """n SignedAggregateAndProofs from the committees of the slots before
    `state.slot`, newest first: in each committee the first
    `per_committee` members whose real selection proof passes
    is_aggregator, the k-th aggregating every member but member k (so
    each aggregate has its own root)."""
    T = C.types
    t = T.types_for(preset)
    spe = preset.slots_per_epoch
    ctxt = C.context.ConsensusContext(preset, spec)
    found = []  # (slot, index, committee, aggregator, proof, k)
    for slot in range(state.slot - 1, -1, -1):
        epoch = slot // spe
        sel_root = T.SigningData(
            object_root=C.ssz.uint64.hash_tree_root(slot),
            domain=T.get_domain(state, T.DOMAIN_SELECTION_PROOF, epoch, preset),
        ).tree_hash_root()
        committees = ctxt.committee_cache(state, epoch).get_all_committees_at_slot(slot)
        for index, committee in enumerate(committees):
            k = 0
            for c0 in range(0, len(committee), SELECTION_CHUNK):
                chunk = committee[c0:c0 + SELECTION_CHUNK]
                proofs = host.sign([([secret_of(m)], sel_root) for m in chunk])
                for member, proof in zip(chunk, proofs):
                    if (len(found) < n and k < per_committee
                            and C.att.is_aggregator(len(committee), proof, spec)):
                        found.append((slot, index, committee, member, proof, k))
                        k += 1
                if len(found) == n or k == per_committee:
                    break
        if len(found) == n:
            break
    need(len(found) == n, f"gossip: {len(found)} of {n} aggregators")
    aggregates, jobs = [], []
    for slot, index, committee, _, _, k in found:
        data = attestation_data(C, state, slot, index, preset)
        bits = tuple(i != k for i in range(len(committee)))
        aggregates.append(t.Attestation(aggregation_bits=bits, data=data))
        jobs.append(([secret_of(v) for v, b in zip(committee, bits) if b],
                     attester_root(C, state, data, preset)))
    for att, sig in zip(aggregates, host.sign(jobs)):
        att.signature = sig
    msgs, jobs = [], []
    for (slot, _, _, member, proof, _), att in zip(found, aggregates):
        msg = t.AggregateAndProof(aggregator_index=member, aggregate=att,
                                  selection_proof=proof)
        domain = T.get_domain(state, T.DOMAIN_AGGREGATE_AND_PROOF, slot // spe, preset)
        msgs.append(msg)
        jobs.append(([secret_of(member)], T.compute_signing_root(msg, domain)))
    return [t.SignedAggregateAndProof(message=msg, signature=sig)
            for msg, sig in zip(msgs, host.sign(jobs))]


def forge_gossip(C, state, preset, spec, secret_of, items, positions, host):
    """A copy of the gossip list whose items at `positions` are signed by
    their signer over a wrong root: an attestation by its attester, an
    aggregate its aggregate-and-proof signature by its aggregator."""
    T = C.types
    spe = preset.slots_per_epoch
    ctxt = C.context.ConsensusContext(preset, spec)
    out, jobs = list(items), []
    for i in positions:
        item = type(items[i]).from_ssz_bytes(items[i].as_ssz_bytes())
        if hasattr(item, "aggregation_bits"):
            data = item.data
            committee = ctxt.committee_cache(state, data.slot // spe).get_beacon_committee(
                data.slot, data.index)
            signer = committee[list(item.aggregation_bits).index(True)]
            root = attester_root(C, state, data, preset)
        else:
            msg = item.message
            signer = msg.aggregator_index
            domain = T.get_domain(state, T.DOMAIN_AGGREGATE_AND_PROOF,
                                  msg.aggregate.data.slot // spe, preset)
            root = T.compute_signing_root(msg, domain)
        jobs.append(([secret_of(signer)], wrong_root(root)))
        out[i] = item
    for i, sig in zip(positions, host.sign(jobs)):
        out[i].signature = sig
    return out


def bisection_bound(k: int, n: int) -> int:
    """Extra backend calls the bisection may spend on k bad items among n
    (tests/test_bls_pipeline.py test_k_bad_costs_k_log_n)."""
    return k * (math.ceil(math.log2(n)) + 1) if n > 1 else 0


class _WallClock:
    """The tracer's clock on the host's monotonic seconds (the port's
    default tracer steps a counter), so span durations are times."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()


def span_ms(C, *names) -> dict:
    spans = C.tracing.default_tracer().finished_spans()
    return {n: sum(sp.duration() for sp in spans if sp.name == n) * 1e3 for n in names}


def gossip_chain(C, state, preset, spec, cache, current_slot):
    """The chain as attestation_verification reads it: its clock, preset
    and spec, the known block roots, the head state, the pubkey cache,
    no validator monitor."""
    from types import SimpleNamespace

    roots = {bytes(r) for r in state.block_roots}
    return SimpleNamespace(current_slot=current_slot, preset=preset, spec=spec,
                           _states={r: state for r in roots}, head_state=state,
                           pubkey_cache=cache, validator_monitor=None)


def run_processor(C, label, lanes, max_batch=1024):
    """Items through a BeaconProcessor (batches of at most `max_batch`
    items). `lanes` is {queue: (name, submit, items, sink)}: the queue's
    handler calls `submit(batch)` and keeps the PendingBatch it returns as
    a DeferredWork whose completion records (verified, rejected) under
    `name` and hands the verified items to `sink(name, verified)` (None: no
    sink), as the node puts them into its pools. Returns ({name:
    (verified, rejected)} over every batch, processor)."""
    out = {}

    def handler(name, submit, sink):
        def handle(items):
            pending = submit(items)

            def complete():
                verified, rejected = pending.complete()
                got = out.setdefault(name, ([], []))
                got[0].extend(verified)
                got[1].extend(rejected)
                if sink is not None:
                    sink(name, verified)
            return C.processor.DeferredWork(done=pending.done, complete=complete)
        return handle

    bp = C.processor.BeaconProcessor(max_batch=max_batch, handlers={
        queue: handler(name, submit, sink)
        for queue, (name, submit, _, sink) in lanes.items()})
    for queue, (_, _, items, _) in lanes.items():
        for item in items:
            need(bp.submit(queue, item), f"{label}: {queue} queue full")
    bp.run_until_idle()
    need(not bp.handler_errors, f"{label}: processor handler errors {bp.last_error}")
    return out, bp


def process_gossip(C, chain, unaggregated=(), aggregates=(), sink=None, max_batch=1024):
    """The attestation batches through `run_processor`, whose gossip
    handlers submit them (`submit_*_batch`). Returns ({"unaggregated" |
    "aggregate": (verified, rejected)} over every batch, processor)."""
    O = C.observed
    attesters, aggs, aggregators = (O.ObservedAttesters(), O.ObservedAggregates(),
                                    O.ObservedAggregators())
    return run_processor(C, "gossip", {
        "gossip_attestation": (
            "unaggregated",
            lambda items: C.att.submit_unaggregated_batch(chain, items, attesters),
            unaggregated, sink),
        "gossip_aggregate": (
            "aggregate",
            lambda items: C.att.submit_aggregate_batch(chain, items, aggs, aggregators),
            aggregates, sink),
    }, max_batch=max_batch)


def verdicts(items, result):
    """(verified, rejected) of a batch as ({root}, {root: reason}) of its
    items."""
    verified, rejected = result
    root = {id(a): a.tree_hash_root() for a in items}
    got = set()
    for v in verified:
        item = v.attestation if hasattr(v, "attestation") else v.signed_aggregate
        got.add(root[id(item)])
    return got, {root[id(a)]: why for a, why in rejected}


def registry(torch, C, host, card, genesis_job, twin_worker):
    """The mainnet-shaped registry the block, attestations and chain
    phases run over: interop genesis under MAINNET with altair at epoch 0,
    tiled to BLOCK_VALIDATORS (made on a worker of the host pool from the
    run's start: `genesis_job`, the future of `_registry_genesis`); a
    BeaconChain on it (over a HotColdDB of a MemoryStore), whose
    ValidatorPubkeyCache, with its device table on the card, the phases
    share; a copy of the genesis state with slot processing to BLOCK_SLOT;
    and the NO_VERIFICATION twin of the chain (`Twin`) in `twin_worker`.
    `host` makes the phases' signatures and oracle verdicts."""
    preset, spec = registry_spec(C)
    t0 = time.perf_counter()
    fork, data, genesis_s, checked_xy = genesis_job.result()
    wait_s = time.perf_counter() - t0
    genesis = state_from_ssz(C, preset, fork, data)
    t1 = time.perf_counter()
    state = C.per_slot.process_slots(C.per_slot.clone_state(genesis), BLOCK_SLOT,
                                     preset, spec)
    t2 = time.perf_counter()
    prevalidate_pubkeys(C, host, genesis, checked_xy)
    chain = C.beacon_chain.BeaconChain(
        C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), genesis, preset, spec)
    cache = chain.pubkey_cache
    t3 = time.perf_counter()
    table = cache.device_table()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    need(table.device.type == "cuda" and len(cache) == BLOCK_VALIDATORS,
         f"registry: {len(cache)} keys, table on {table.device}")
    cpc = C.context.ConsensusContext(preset, spec).committee_cache(state, 0)
    need(cpc.committees_per_slot == 4 and
         len(cpc.get_beacon_committee(0, 0)) == 128,
         f"registry: {cpc.committees_per_slot} committees a slot")
    twin = Twin((fork, data), preset, spec, checked_xy, twin_worker)
    out = dict(validators=BLOCK_VALIDATORS, distinct_keys=BLOCK_DISTINCT_KEYS,
               genesis_s=genesis_s, wait_s=wait_s, decode_s=t1 - t0 - wait_s,
               slots_s=t2 - t1, chain_init_s=t3 - t2, table_upload_ms=(t4 - t3) * 1e3)
    log(f"registry: {BLOCK_VALIDATORS} validators tiled from "
        f"{BLOCK_DISTINCT_KEYS} interop keys, {preset.name}, altair: genesis "
        f"{genesis_s:.1f} s (then the keys' checks) on a worker of the host pool from "
        f"the run's start (waited {wait_s:.1f} s for it; SSZ decode "
        f"{out['decode_s']:.1f} s), "
        f"process_slots to {BLOCK_SLOT} {out['slots_s']:.1f} s, BeaconChain with its "
        f"pubkey cache {out['chain_init_s']:.1f} s, device table "
        f"{out['table_upload_ms']:.1f} ms; card: {card}")
    from types import SimpleNamespace

    return SimpleNamespace(state=state, genesis=genesis, genesis_ssz=(fork, data),
                           checked_xy=checked_xy, chain=chain, preset=preset, spec=spec,
                           cache=cache, secret_of=tiled_secret_of(C, BLOCK_DISTINCT_KEYS),
                           host=host, summary=out, block=None, twin=twin)


def phase_block(torch, K, TP, B, C, reg, launches, card):
    """One mainnet-shaped block's signatures through the chain's wiring;
    the cpu oracle's two verdicts run on the host pool meanwhile."""
    state, preset, spec, cache, host = reg.state, reg.preset, reg.spec, reg.cache, reg.host
    t0 = time.perf_counter()
    reg.block = produce_block(C, state, preset, spec, reg.secret_of, host)
    block = reg.block[0]
    forged = forge_attestation(C, state, preset, spec, reg.secret_of, block, 7, host)
    sign_s = time.perf_counter() - t0

    def verifier(signed):
        v = C.bsv.BlockSignatureVerifier(
            state, preset, spec, get_pubkey=cache.getter(state),
            resolve_pubkey=cache.resolve)
        t = time.perf_counter()
        v.include_all_signatures(signed)
        return v, (time.perf_counter() - t) * 1e3

    v, build_ms = verifier(block)
    fv, _ = verifier(forged)
    t_oracle = time.perf_counter()
    oracle = host.oracle([v.sets, fv.sets], seed=31)
    sets, keys = len(v.sets), block_key_count(v.sets)
    need(sets == 131 and len(block.message.body.attestations) == 128,
         f"block: {sets} sets")
    need(16384 <= keys <= 16900, f"block: {keys} keys")
    need(B._common_table(v.sets) is cache, "block: the sets are not table-tagged")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb = B._marshal_batch(v.sets, "cuda", seed=31)
    torch.cuda.synchronize()
    marshal_ms = (time.perf_counter() - t0) * 1e3
    packed = B._marshal_batch(untagged(C, v.sets), "cuda", seed=31)
    need(torch.equal(mb.pk, packed.pk),
         "block: gathered pk differs from the host-packed pk")
    aggregated = mb.grid_idx is not None
    n_b, k_b, m_b = mb.pk.shape[0], mb.pk.shape[1], mb.u.shape[0]
    pairs = (m_b if aggregated else n_b) + 1

    t0 = time.perf_counter()
    need(v.verify(slot=BLOCK_SLOT) is True, "block: honest block rejected (first)")
    first_s = time.perf_counter() - t0
    K.reset_launches()
    t0 = time.perf_counter()
    ok = v.verify(slot=BLOCK_SLOT)
    verify_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(K.LAUNCHES)
    need(ok is True, "block: honest block rejected")
    check_launches("block", counts, expected_launches(TP, pairs))
    add_launches(launches, counts)
    t0 = time.perf_counter()
    need(fv.verify(slot=BLOCK_SLOT) is False, "block: forged block accepted")
    forged_ms = (time.perf_counter() - t0) * 1e3
    cpu_honest, cpu_forged = oracle()
    cpu_s = time.perf_counter() - t_oracle
    need(cpu_honest is True and cpu_forged is False,
         f"block: cpu oracle {cpu_honest} / {cpu_forged}, card True / False")
    log(f"block: {sets} sets, {keys} keys gathered by index from the "
        f"{len(cache)}-row table (pk equal to the host-packed route), bucket "
        f"n_b {n_b} k_b {k_b} m_b {m_b}, {'aggregated' if aggregated else 'per-set'} "
        f"path, {pairs} pairs; host: sign {sign_s:.1f} s, build sets "
        f"{build_ms:.1f} ms, marshal {marshal_ms:.1f} ms; card: first verify "
        f"{first_s:.3f} s, replayed {verify_ms:.1f} ms (honest True), forged "
        f"{forged_ms:.1f} ms (False); cpu oracle True / False, both verdicts "
        f"{cpu_s:.1f} s from their start, beside the card's work; launches "
        f"{counts}; card: {card}")
    return dict(sets=sets, keys=keys, bucket=[n_b, k_b, m_b], aggregated=aggregated,
                pairs=pairs, sign_s=sign_s, build_sets_ms=build_ms,
                marshal_ms=marshal_ms, first_s=first_s, verify_ms=verify_ms,
                forged_ms=forged_ms, cpu_oracle_s=cpu_s, launches=counts)


def phase_attestations(torch, K, B, C, reg, launches, card):
    """Gossip batches through the beacon processor: honest, then with 1 and
    3 planted forgeries in each batch, against the sync batch_verify_*."""
    state, preset, spec, cache, host = reg.state, reg.preset, reg.spec, reg.cache, reg.host
    M = C.metrics
    C.tracing.configure(clock=_WallClock())
    chain = gossip_chain(C, state, preset, spec, cache, BLOCK_SLOT)
    t0 = time.perf_counter()
    unagg = {(): gossip_unaggregated(C, state, preset, spec, reg.secret_of,
                                     BLOCK_SLOT - 1, GOSSIP_UNAGGREGATED, host)}
    aggs = {(): gossip_aggregates(C, state, preset, spec, reg.secret_of,
                                  GOSSIP_AGGREGATES, host)}
    for family, forged in ((unagg, FORGED_UNAGGREGATED), (aggs, FORGED_AGGREGATES)):
        for bad in forged:
            family[bad] = forge_gossip(C, state, preset, spec, reg.secret_of,
                                       family[()], bad, host)
    sign_s = time.perf_counter() - t0
    out = dict(sign_s=sign_s)

    graphs0 = graph_count(B)
    K.reset_launches()
    t0 = time.perf_counter()
    res, bp = process_gossip(C, chain, unagg[()], aggs[()])
    honest_s = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    check_launches("attestations", counts, {})
    add_launches(launches, counts)
    spans = span_ms(C, "att_setup", "att_verify_wait", "agg_setup", "agg_verify_wait")
    for name, items in (("unaggregated", unagg[()]), ("aggregate", aggs[()])):
        got, rejected = verdicts(items, res[name])
        need(len(got) == len(items) and not rejected,
             f"attestations: {name}: {len(got)} of {len(items)} verified, "
             f"rejected {sorted(rejected.values())}")
    sync = {
        "unaggregated": verdicts(unagg[()], C.att.batch_verify_unaggregated(
            chain, unagg[()], C.observed.ObservedAttesters())),
        "aggregate": verdicts(aggs[()], C.att.batch_verify_aggregates(
            chain, aggs[()], C.observed.ObservedAggregates(),
            C.observed.ObservedAggregators())),
    }
    for name, items in (("unaggregated", unagg[()]), ("aggregate", aggs[()])):
        need(verdicts(items, res[name]) == sync[name],
             f"attestations: {name}: processor and sync verdicts differ")
    log(f"attestations: honest {len(unagg[()])} unaggregated + {len(aggs[()])} "
        f"aggregates ({3 * len(aggs[()])} sets) through the BeaconProcessor, "
        f"all verified, equal to the sync batch_verify_*; {honest_s:.3f} s, "
        f"{graph_count(B) - graphs0} stage graphs captured; host sign "
        f"{sign_s:.1f} s; span ms "
        f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}; "
        f"launches {counts}; card: {card}")
    out["honest"] = dict(seconds=honest_s, spans=spans,
                         graphs_captured=graph_count(B) - graphs0,
                         processed=dict(bp.processed), launches=counts)
    for name, family, kind in (("unaggregated", unagg, "att"),
                               ("aggregate", aggs, "agg")):
        for bad in [b for b in family if b]:
            items = family[bad]
            C.tracing.default_tracer().reset()
            calls0 = M.BLS_BISECTION_CALLS.value
            graphs0 = graph_count(B)
            t0 = time.perf_counter()
            res, _ = process_gossip(
                C, chain, **{"unaggregated" if kind == "att" else "aggregates": items})
            secs = time.perf_counter() - t0
            calls = int(M.BLS_BISECTION_CALLS.value - calls0)
            got, rejected = verdicts(items, res[name])
            want_bad = {items[i].tree_hash_root() for i in bad}
            need(rejected == {r: "invalid signature" for r in want_bad},
                 f"attestations: {name} {bad}: rejected {rejected}")
            need(len(got) == len(items) - len(bad) and not (got & want_bad),
                 f"attestations: {name} {bad}: {len(got)} verified")
            limit = bisection_bound(len(bad), len(items))
            need(calls <= limit, f"attestations: {name} {bad}: {calls} bisection "
                 f"calls, bound {limit}")
            spans = span_ms(C, f"{kind}_setup", f"{kind}_verify_wait", f"{kind}_bisect")
            log(f"attestations: {name} with forgeries at {list(bad)}: exactly those "
                f"rejected (invalid signature), {len(got)} verified; {calls} "
                f"bisection calls (bound {limit}); {secs:.3f} s, "
                f"{graph_count(B) - graphs0} stage graphs captured; span ms "
                f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}; card: {card}")
            out[f"{name}-{len(bad)}"] = dict(
                seconds=secs, bisection_calls=calls, bound=limit, spans=spans,
                graphs_captured=graph_count(B) - graphs0)
    return out


CHAIN_SEGMENT = 4  # range sync's segment: blocks BLOCK_SLOT + 2 .. + 5
CHAIN_FORGED = 2  # the segment's block whose attestation 5 is forged
CHAIN_SPANS = ("block_gossip_verify", "block_signature_verify", "block_transition",
               "state_root", "fork_choice", "block_import")


@contextlib.contextmanager
def backend_calls(B, M):
    """Every batch that reaches torch_cuda's dispatch within the block
    (the sync and the pipelined verify both end there): its sets, its
    Miller pairs and its verdict as dispatched (a device bool, or False
    when a structural check decided it, with 0 pairs); and every call of
    torch_cuda's aggregate_verify (one signature over distinct messages):
    its (signature, pubkeys, messages) as `agg`, no sets, the pairs of its
    Miller stage (the keys' bucket + 1) and its verdict."""
    import functools

    calls = []
    real, real_agg = B.dispatch_verify_signature_sets, B.aggregate_verify

    @functools.wraps(real)
    def spy(sets, *args, **kwargs):
        pairs0 = M.BLS_MILLER_PAIRS.value
        out = real(sets, *args, **kwargs)
        calls.append(dict(sets=list(sets), pairs=int(M.BLS_MILLER_PAIRS.value - pairs0),
                          out=out))
        return out

    @functools.wraps(real_agg)
    def spy_agg(signature, pubkeys, messages, *args, **kwargs):
        out = real_agg(signature, pubkeys, messages, *args, **kwargs)
        calls.append(dict(sets=[], agg=(signature, list(pubkeys), list(messages)),
                          pairs=B._bucket(len(pubkeys)) + 1, out=out))
        return out

    B.dispatch_verify_signature_sets, B.aggregate_verify = spy, spy_agg
    try:
        yield calls
    finally:
        B.dispatch_verify_signature_sets, B.aggregate_verify = real, real_agg


def oracle_verdict(host, sets, seed):
    """A callable that returns the cpu oracle backend's verdict on `sets`:
    the batch split into one part a worker, each part verified on the
    host pool meanwhile (a batch holds iff every part does)."""
    parts = max(1, min(len(sets), 8))
    size = -(-len(sets) // parts)
    verdicts = host.oracle([sets[i:i + size] for i in range(0, len(sets), size)], seed)
    return lambda: all(verdicts())


def produce_segment(C, state, preset, spec, secret_of, host, n, forge=None):
    """n parent-linked blocks at the slots after `state`'s, each built on
    the post-state of the one before (as a proposer would); `forge` = k
    forges attestation k of the first. Returns (blocks, post-states)."""
    blocks, posts = [], []
    for i in range(n):
        state = C.per_slot.process_slots(C.per_slot.clone_state(state), state.slot + 1,
                                         preset, spec)
        signed, state = produce_block(C, state, preset, spec, secret_of, host,
                                      forge=forge if i == 0 else None)
        blocks.append(signed)
        posts.append(state)
    return blocks, posts


def chain_view(C, chain):
    """What the chain's two twins must agree on: head root, head state
    root, justified and finalized checkpoints."""
    return (chain.head_root, C.ssz.cached_root(chain.head_state),
            chain.justified_checkpoint, chain.finalized_checkpoint)


def phase_chain(torch, K, TP, B, C, reg, launches, card):
    """Block import on the card through the chain's own entry points: a
    gossip block, an epoch-boundary block and a range-sync segment, then
    a forged segment and a forged proposal; every backend call against
    the cpu oracle, the head against a twin chain that imported the same
    blocks without signature checks."""
    preset, spec, host, chain = reg.preset, reg.spec, reg.host, reg.chain
    M, PS = C.metrics, C.per_slot
    t_phase = time.perf_counter()
    C.tracing.configure(clock=_WallClock())

    t0 = time.perf_counter()
    b31, post31 = reg.block or produce_block(C, reg.state, preset, spec,
                                             reg.secret_of, host)
    (b32,), (post32,) = produce_segment(C, post31, preset, spec, reg.secret_of, host, 1)
    segment, posts = produce_segment(C, post32, preset, spec, reg.secret_of, host,
                                     CHAIN_SEGMENT)
    forged_tail, _ = produce_segment(C, posts[CHAIN_FORGED - 1], preset, spec,
                                     reg.secret_of, host, CHAIN_SEGMENT - CHAIN_FORGED,
                                     forge=5)
    forged_segment = segment[:CHAIN_FORGED] + forged_tail
    s_bad = PS.process_slots(PS.clone_state(posts[-1]), posts[-1].slot + 1, preset, spec)
    bad_gossip, _ = produce_block(C, s_bad, preset, spec, reg.secret_of, host,
                                  attest=False, forge_proposal=True)
    build_s = time.perf_counter() - t0
    log(f"chain: built blocks {b31.message.slot}-{segment[-1].message.slot} with their "
        f"state roots, a forged segment and a forged proposal in {build_s:.1f} s")
    reg.twin.import_([b31, b32] + segment)  # the blocks the chain imports, in order

    epoch_ms = []
    process_epoch = C.per_epoch.process_epoch

    def timed_epoch(*args, **kwargs):
        t = time.perf_counter()
        process_epoch(*args, **kwargs)
        epoch_ms.append((time.perf_counter() - t) * 1e3)

    calls, out, sets_of = Calls(torch, K, TP, B, C, host, launches, card), {}, {}

    def n_sets(*blocks):
        """A block's sets: its attestations, the sync aggregate, the randao
        reveal and the proposal (131 at the registry's shape)."""
        return sum(len(b.message.body.attestations) + 3 for b in blocks)

    def step(label, slot, fn, want_calls, want_error=None, moves_head=True):
        """fn() as one of the phase's `Calls` steps, with the tracer reset;
        checks its error, its backend calls' set counts and the head (moved
        to the block it returns, or unchanged)."""
        chain.slot_clock.set_slot(slot)
        head0 = chain.head_root
        C.tracing.default_tracer().reset()
        sig0 = M.BLOCK_SIGNATURE_TIMES.sum

        def run():
            try:
                return fn(), None
            except C.beacon_chain.BlockError as e:
                return None, str(e)

        (result, err), step_calls = calls.step(f"chain: {label}", run, want_calls)
        need(err == want_error, f"chain: {label}: error {err!r}, want {want_error!r}")
        sets_of[label] = [c["sets"] for c in step_calls]
        if moves_head:
            need(chain.head_root == result, f"chain: {label}: head did not move")
        else:
            need(chain.head_root == head0, f"chain: {label}: head moved")
        spans = span_ms(C, *CHAIN_SPANS)
        row = calls.rows[f"chain: {label}"]
        row.update(signature_ms=(M.BLOCK_SIGNATURE_TIMES.sum - sig0) * 1e3, spans=spans)
        log(f"chain: {label}: span ms "
            f"{json.dumps({k: round(v, 1) for k, v in spans.items()})}; card: {card}")
        out[label] = row
        return result

    step("gossip", b31.message.slot, lambda: C.bv.process_gossip_block(chain, b31),
         [1, n_sets(b31) - 1])
    C.per_epoch.process_epoch = timed_epoch
    try:
        step("boundary", b32.message.slot, lambda: chain.process_block(b32), [n_sets(b32)])
    finally:
        C.per_epoch.process_epoch = process_epoch
    need(len(epoch_ms) == 1, f"chain: {len(epoch_ms)} epoch transitions at the boundary")
    out["boundary"]["process_epoch_ms"] = epoch_ms[0]
    log(f"chain: boundary: process_epoch over {len(chain.head_state.validators)} "
        f"validators {epoch_ms[0]:.1f} ms; card: {card}")

    include = C.bsv.BlockSignatureVerifier.include_all_signatures
    sets_ms = []

    def timed_include(self, signed):
        t = time.perf_counter()
        include(self, signed)
        sets_ms.append((time.perf_counter() - t) * 1e3)

    last = segment[-1].message.slot
    C.bsv.BlockSignatureVerifier.include_all_signatures = timed_include
    try:
        verified = step("segment", last, lambda: C.bv.signature_verify_chain_segment(
            chain, segment), [n_sets(*segment)], moves_head=False)
    finally:
        C.bsv.BlockSignatureVerifier.include_all_signatures = include
    C.tracing.default_tracer().reset()
    t = time.perf_counter()
    with backend_calls(B, M) as import_calls:
        roots = [v.import_into(chain) for v in verified]
    import_s = time.perf_counter() - t
    import_spans = span_ms(C, *CHAIN_SPANS)
    need(not import_calls and chain.head_root == roots[-1],
         f"chain: segment import made {len(import_calls)} backend calls")
    seg_sets, = sets_of["segment"]
    mb = B._marshal_batch(seg_sets, "cuda", seed=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    need(C.api.verify_signature_sets(seg_sets) is True, "chain: segment replay rejected")
    replay_ms = (time.perf_counter() - t) * 1e3
    out["segment"].update(
        bucket=[int(mb.pk.shape[0]), int(mb.pk.shape[1]), int(mb.u.shape[0])],
        aggregated=mb.grid_idx is not None, first_call_s=out["segment"]["signature_ms"] / 1e3,
        replayed_ms=replay_ms, build_sets_ms=sum(sets_ms), import_s=import_s,
        import_spans=import_spans,
        host_ms=out["segment"]["seconds"] * 1e3 - out["segment"]["signature_ms"])
    log(f"chain: segment of {CHAIN_SEGMENT} blocks ({last - CHAIN_SEGMENT + 1}-{last}): "
        f"one backend call of {out['segment']['calls'][0]} sets, "
        f"{out['segment']['keys'][0]} keys, bucket {out['segment']['bucket']} "
        f"({'aggregated' if out['segment']['aggregated'] else 'per-set'}), "
        f"{out['segment']['pairs'][0]} pairs; first call "
        f"{out['segment']['first_call_s']:.3f} s, replayed {replay_ms:.1f} ms; host: "
        f"sets {sum(sets_ms):.1f} ms, state advance + sets "
        f"{out['segment']['host_ms']:.1f} ms; import of the {CHAIN_SEGMENT} blocks "
        f"{import_s:.3f} s, span ms "
        f"{json.dumps({k: round(v, 1) for k, v in import_spans.items()})}; card: {card}")

    step("forged segment", last, lambda: C.bv.signature_verify_chain_segment(
        chain, forged_segment), [n_sets(*forged_segment)],
        want_error="segment signature batch failed", moves_head=False)
    step("forged proposal", bad_gossip.message.slot,
         lambda: C.bv.process_gossip_block(chain, bad_gossip), [1],
         want_error="invalid proposer signature", moves_head=False)

    reg.twin.expect("chain", chain, C)
    oracle_wait_s = calls.check_oracle("chain")
    got = [v for _, v, _ in calls.oracles]
    need(got == [True] * 4 + [False] * 2, f"chain: verdicts {got}")
    head_slot = chain.head_state.slot
    jc, fc = chain.justified_checkpoint, chain.finalized_checkpoint
    out.update(build_s=build_s, oracle_wait_s=oracle_wait_s,
               head_slot=int(head_slot), justified_epoch=int(jc[0]),
               finalized_epoch=int(fc[0]), seconds=time.perf_counter() - t_phase)
    log(f"chain: head at slot {head_slot}, justified epoch {jc[0]}, finalized epoch "
        f"{fc[0]} (held to the twin's at the end of the run); every verdict "
        f"{got} equal to the cpu oracle's (waited {oracle_wait_s:.1f} "
        f"s at the end); phase wall {out['seconds']:.1f} s; card: {card}")
    return out


def twin_worker():
    """A worker process of its own for the NO_VERIFICATION twins (`Twin`):
    spawned (no card state reaches it), one process, so it runs what it
    is given in order and its chains live from one call to the next; shut
    down by the caller (`with`)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))


_TWINS = {}  # the twins' chains in the process that runs them, by name


def _twin_start(name, genesis, preset, spec, checked_xy):
    """Twin worker: twin `name`'s chain, on the CPU, over the genesis given
    as (fork, SSZ bytes); `checked_xy` (the registry's checked keys, or
    None) feeds its pubkey cache as `prevalidate_pubkeys` feeds the
    script's."""
    C = consensus_modules()
    state = state_from_ssz(C, preset, *genesis)
    if checked_xy is not None:
        prevalidate_pubkeys(C, None, state, checked_xy)
    _TWINS[name] = C.beacon_chain.BeaconChain(
        C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), state, preset, spec,
        device="cpu")


def _twin_import(name, blocks):
    """Twin worker: the blocks, given as (fork, SSZ bytes), imported into
    twin `name` with NO_VERIFICATION, in order: each block's root and the
    twin's view (`chain_view`) after it, and the seconds."""
    C = consensus_modules()
    chain, t0 = _TWINS[name], time.perf_counter()
    t = C.types.types_for(chain.preset)
    views = []
    for fork, data in blocks:
        signed = C.types.block_classes_for(t, fork)[1].from_ssz_bytes(data)
        chain.slot_clock.set_slot(signed.message.slot)
        root = chain.process_block(
            signed, strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION)
        views.append((root, chain_view(C, chain)))
    return views, time.perf_counter() - t0


def _twin_close(name):
    """Twin worker: twin `name`'s chain dropped."""
    _TWINS.pop(name, None)


class Twin:
    """A chain over the same genesis that imports, with NO_VERIFICATION,
    the blocks a chain of the script imports, in the order given
    (`import_`; `imported` keeps them), and holds that chain's head, head
    state root and checkpoints, read when `expect` is called, to its own
    view after the same head block (`check`). In `worker` (`twin_worker`)
    the twin's imports go on beside the phases and `check` waits for
    them; with no worker they run here, at once."""

    _count = 0

    def __init__(self, genesis, preset, spec, checked_xy=None, worker=None):
        Twin._count += 1
        self.name, self.worker = f"twin-{Twin._count}", worker
        self.jobs, self.expected, self.views = [], [], {}
        self.submitted, self.imported, self.seconds = set(), [], 0.0
        self._run(_twin_start, self.name, genesis, preset, spec, checked_xy)

    def _run(self, fn, *args):
        if self.worker is None:
            result = fn(*args)
            self.jobs.append(lambda: result)
        else:
            self.jobs.append(self.worker.submit(fn, *args).result)

    def import_(self, blocks):
        """The twin imports those of `blocks` it has not been given yet."""
        todo = []
        for b in blocks:
            root = b.message.tree_hash_root()
            if root not in self.submitted:
                self.submitted.add(root)
                self.imported.append(b)
                todo.append((type(b).fork_name, b.as_ssz_bytes()))
        if todo:
            self._run(_twin_import, self.name, todo)

    def expect(self, label, chain, C):
        """`chain`'s view now, to be held to the twin's after its head."""
        self.expected.append((label, chain.head_root, chain_view(C, chain)))

    def check(self) -> float:
        """Wait for the twin's imports and hold every expected view to its
        own; returns the seconds waited."""
        t0 = time.perf_counter()
        for job in self.jobs:
            result = job()
            if result is not None:
                views, secs = result
                self.views.update(views)
                self.seconds += secs
        self.jobs = []
        wait_s = time.perf_counter() - t0
        for label, root, view in self.expected:
            need(root in self.views, f"{label}: the twin imported no block "
                 f"0x{root.hex()[:16]}")
            need(self.views[root] == view,
                 f"{label}: head or checkpoints differ from the NO_VERIFICATION twin's")
        self.expected = []
        return wait_s

    def close(self):
        self._run(_twin_close, self.name)
        self.jobs.pop()()


def twin_check(reg, card) -> dict:
    """The registry twin's check, after the registry's phases: every view
    the phases expected (`Twin.expect`) held to the twin's."""
    twin = reg.twin
    labels = [label for label, _, _ in twin.expected]
    wait_s = twin.check()
    twin.close()
    log(f"twin: {len(twin.imported)} blocks imported with NO_VERIFICATION in "
        f"{twin.seconds:.1f} s in its worker, beside the phases (waited {wait_s:.1f} "
        f"s); the heads, head state roots and checkpoints of {labels} equal to the "
        f"twin's; card: {card}")
    return dict(blocks=len(twin.imported), seconds=twin.seconds, wait_s=wait_s,
                held=labels)


class Calls:
    """The steps of a phase that reach the card: each step runs with the
    kernels' launch counts at 0 and torch_cuda's dispatch spied on
    (`backend_calls`); its launches must be what its calls' Miller pairs
    imply (`expected_launches`), and each call's sets go to the cpu oracle
    on the host pool, whose verdicts `check_oracle` compares with the
    card's at the end of the phase."""

    def __init__(self, torch, K, TP, B, C, host, launches, card):
        self.torch, self.K, self.TP, self.B, self.C = torch, K, TP, B, C
        self.host, self.launches, self.card = host, launches, card
        self.oracles, self.rows = [], {}

    def step(self, label, fn, want_calls=None):
        """fn() as one step; returns (fn's result, the step's calls)."""
        K, M = self.K, self.C.metrics
        K.reset_launches()
        t = time.perf_counter()
        with backend_calls(self.B, M) as calls:
            result = fn()
        secs = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        sizes = [1 if "agg" in c else len(c["sets"]) for c in calls]
        need(calls, f"{label}: no backend call")
        if want_calls is not None:
            need(sizes == want_calls, f"{label}: backend calls of {sizes} sets, "
                 f"want {want_calls}")
        want = {}
        for c in calls:
            if c["pairs"]:  # 0: a structural check decided it, no device work
                add_launches(want, expected_launches(self.TP, c["pairs"]))
        if want:
            check_launches(label, counts, want)
        else:
            need(not any(counts.values()), f"{label}: launches {counts} without a "
                 "device call")
        add_launches(self.launches, counts)
        verdicts = [bool(c["out"]) for c in calls]
        for c, v in zip(calls, verdicts):
            self.oracles.append((label, v, self.host.oracle_aggregate(*c["agg"])
                                 if "agg" in c else oracle_verdict(self.host, c["sets"], 41)))
        row = dict(seconds=secs, calls=sizes,
                   keys=[len(c["agg"][1]) if "agg" in c else block_key_count(c["sets"])
                         for c in calls],
                   pairs=[c["pairs"] for c in calls], verdicts=verdicts, launches=counts)
        self.rows[label] = row
        shown = (f"{sizes} sets ({row['keys']} keys, {row['pairs']} pairs, verdicts "
                 f"{verdicts})" if len(calls) <= 8 else
                 f"{len(calls)} calls of {sum(sizes)} sets ({sum(row['keys'])} keys, "
                 f"{verdicts.count(False)} False)")
        log(f"{label}: {secs:.3f} s, backend calls {shown}; launches {counts}; "
            f"card: {self.card}")
        return result, calls

    def replay(self, label, sets, want=True):
        """The same sets once more through the sync entry point (its
        bucket's graphs captured by the step): the replayed ms."""
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        ok = self.C.api.verify_signature_sets(sets)
        ms = (time.perf_counter() - t) * 1e3
        need(ok is want, f"{label}: replay {ok}, want {want}")
        self.rows[label]["replayed_ms"] = ms
        log(f"{label}: replayed {ms:.1f} ms ({len(sets)} sets, "
            f"{block_key_count(sets)} keys); card: {self.card}")
        return ms

    def check_oracle(self, phase) -> float:
        """Every step's card verdicts against the cpu oracle's; returns the
        seconds spent waiting for the oracle."""
        t0 = time.perf_counter()
        got = [(label, v, oracle()) for label, v, oracle in self.oracles]
        for label, v, cpu in got:
            need(v == cpu, f"{phase}: {label}: card {v}, cpu oracle {cpu}")
        return time.perf_counter() - t0


# --- the sync phase: sync-committee messages and contributions, the light client


# one forged message and one forged contribution: the 3-forgery runs (~20 s
# each on the card) were cut to keep the default run under its limit once the
# genesis, finality and network phases came; the unaggregated attestations
# keep theirs
SYNC_FORGED_MESSAGES = ((17,),)
SYNC_FORGED_CONTRIBUTIONS = ((5,),)
SYNC_AGGREGATORS = 4  # contributions a subnet (~16 aggregators a subnet on mainnet)
SYNC_MONITORED = 64  # the validator monitor registers the first 64 positions' senders


def sync_committee_members(C, state, preset):
    """A validator index for each position of the current sync committee,
    the position's key's holders taken in turn: under the tiled registry
    a key sits at several positions and each has its own sender, as in
    the untiled registry."""
    holders = {}
    for i, v in enumerate(state.validators):
        holders.setdefault(bytes(v.pubkey), []).append(i)
    taken, out = {}, []
    for pk in state.current_sync_committee.pubkeys:
        pk = bytes(pk)
        n = taken.get(pk, 0)
        taken[pk] = n + 1
        out.append(holders[pk][n % len(holders[pk])])
    return out


def sync_messages(C, state, preset, spec, secret_of, slot, root, host, forge=(),
                  positions=None):
    """[(SyncCommitteeMessage, subnet)] of `slot` over block `root`: one a
    position of the current sync committee (or of each of `positions`),
    from `sync_committee_members`; the positions in `forge` sign a wrong
    root."""
    T = C.types
    members = sync_committee_members(C, state, preset)
    positions = range(len(members)) if positions is None else positions
    domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE, slot // preset.slots_per_epoch,
                          preset)
    signing = T.SigningData(object_root=bytes(root), domain=domain).tree_hash_root()
    sigs = host.sign([([secret_of(members[p])], wrong_root(signing) if p in forge
                       else signing) for p in positions])
    size = preset.sync_subcommittee_size
    return [(T.SyncCommitteeMessage(slot=slot, beacon_block_root=bytes(root),
                                    validator_index=members[p], signature=sig), p // size)
            for p, sig in zip(positions, sigs)]


def sync_contributions(C, state, preset, spec, secret_of, slot, root, pool, host,
                       per_subnet=SYNC_AGGREGATORS):
    """SignedContributionAndProofs of `slot`: in each subnet the first
    `per_subnet` senders (`sync_committee_members`, in committee order)
    whose selection proof passes is_sync_committee_aggregator, each
    wrapping the subnet's contribution over `root` that the message pool
    `pool` aggregates."""
    T = C.types
    t = T.types_for(preset)
    epoch = slot // preset.slots_per_epoch
    members = sync_committee_members(C, state, preset)
    size = preset.sync_subcommittee_size
    sel_domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch, preset)
    found = []
    for subnet in range(preset.sync_committee_subnet_count):
        sel_root = T.compute_signing_root(C.containers.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subnet), sel_domain)
        sub, k = members[subnet * size:(subnet + 1) * size], 0
        for c0 in range(0, size, SELECTION_CHUNK):
            chunk = sub[c0:c0 + SELECTION_CHUNK]
            for m, proof in zip(chunk, host.sign([([secret_of(m)], sel_root)
                                                   for m in chunk])):
                if k < per_subnet and C.sync.is_sync_committee_aggregator(
                        proof, preset, spec):
                    found.append((subnet, m, proof))
                    k += 1
            if k == per_subnet:
                break
    need(len(found) == per_subnet * preset.sync_committee_subnet_count,
         f"sync: {len(found)} aggregators")
    msgs = [t.ContributionAndProof(
        aggregator_index=m, contribution=pool.get_contribution(t, slot, root, subnet),
        selection_proof=proof) for subnet, m, proof in found]
    domain = T.get_domain(state, T.DOMAIN_CONTRIBUTION_AND_PROOF, epoch, preset)
    sigs = host.sign([([secret_of(m.aggregator_index)], T.compute_signing_root(m, domain))
                      for m in msgs])
    return [t.SignedContributionAndProof(message=m, signature=s) for m, s in zip(msgs, sigs)]


def forge_contributions(C, state, preset, secret_of, items, positions, host):
    """A copy of the contributions whose items at `positions` have their
    contribution-and-proof signed over a wrong root."""
    T = C.types
    out, jobs = list(items), []
    for i in positions:
        item = type(items[i]).from_ssz_bytes(items[i].as_ssz_bytes())
        msg = item.message
        domain = T.get_domain(state, T.DOMAIN_CONTRIBUTION_AND_PROOF,
                              msg.contribution.slot // preset.slots_per_epoch, preset)
        jobs.append(([secret_of(msg.aggregator_index)],
                     wrong_root(T.compute_signing_root(msg, domain))))
        out[i] = item
    for i, sig in zip(positions, host.sign(jobs)):
        out[i].signature = sig
    return out


def process_sync(C, chain, pools, messages=(), contributions=()):
    """The sync batches through `run_processor`, whose `gossip_sync_message`
    and `gossip_sync_contribution` handlers submit them
    (`submit_sync_message_batch`, `submit_contribution_batch`, each one
    call on the sync lane) and, on completion, put the verified items
    into `pools` (.messages, .contributions) and the chain's validator
    monitor, as the node's sync lanes do; fresh dedup caches each call.
    Returns ({"messages" | "contributions": (verified, rejected)},
    processor)."""
    S = C.sync
    contributors, aggregators = S.ObservedSyncContributors(), S.ObservedSyncAggregators()
    seen = C.observed.ObservedAggregates()

    def on_messages(_, verified):
        for v in verified:
            pools.messages.insert(v)
            if chain.validator_monitor is not None:
                chain.validator_monitor.on_sync_committee_message(
                    int(v.message.validator_index), int(v.message.slot))

    def on_contributions(_, verified):
        for v in verified:
            pools.contributions.insert(v)

    return run_processor(C, "sync", {
        "gossip_sync_message": (
            "messages",
            lambda items: S.submit_sync_message_batch(chain, items, contributors),
            messages, on_messages),
        "gossip_sync_contribution": (
            "contributions",
            lambda items: S.submit_contribution_batch(chain, items, aggregators, seen),
            contributions, on_contributions),
    })


def sync_pools(C, preset):
    from types import SimpleNamespace

    return SimpleNamespace(messages=C.sync.SyncMessagePool(preset),
                           contributions=C.sync.SyncContributionPool(preset))


def seed_light_client(C, store, committee, pubkey_cache):
    """Fill the store's parse cache as its own parse fills it: untagged
    keys (a light client has no validator table, so its verify packs the
    keys' limbs on the host) at the points of the chain's pubkey cache (a
    key costs ~23 ms of host Python to decompress; the points are the
    same)."""
    store._parsed_committees[committee.tree_hash_root()] = [
        C.api.PublicKey(k.point, k.to_bytes(), subgroup_checked=True)
        for k in map(pubkey_cache.resolve, map(bytes, committee.pubkeys))]


def item_root(item):
    """A gossip item's root: a sync message's (it travels with its subnet)
    or the item's own."""
    return (item[0] if isinstance(item, tuple) else item).tree_hash_root()


def forged_run(C, calls, label, run, items, bad, name):
    """`run(items)` (a processor pass over a batch with forgeries at `bad`)
    as a step: exactly those items rejected ("invalid signature"), every
    other verified, the bisection within its bound."""
    M = C.metrics
    calls0 = M.BLS_BISECTION_CALLS.value
    (res, _), _ = calls.step(label, lambda: run(items))
    extra = int(M.BLS_BISECTION_CALLS.value - calls0)
    verified, rejected = res[name]
    want_bad = {item_root(items[i]) for i in bad}
    got_rejected = {item_root(x): why for x, why in rejected}
    need(got_rejected == {r: "invalid signature" for r in want_bad},
         f"{label}: rejected {got_rejected}")
    need(len(verified) == len(items) - len(bad), f"{label}: {len(verified)} verified")
    limit = bisection_bound(len(bad), len(items))
    need(extra <= limit, f"{label}: {extra} bisection calls, bound {limit}")
    calls.rows[label].update(bisection_calls=extra, bound=limit)
    log(f"{label}: exactly the forgeries at {list(bad)} rejected, {len(verified)} "
        f"verified; {extra} bisection calls (bound {limit})")
    return res[name]


def phase_sync(torch, K, TP, B, C, reg, launches, card):
    """The sync committee's traffic on the card over the chain phase's
    chain: one slot's messages and contributions through the processor,
    with forgeries; the next block with the contribution pool's sync
    aggregate; a light client following the chain; the validator monitor.
    Every call against the cpu oracle, the head against the twin chain."""
    preset, spec, host, chain = reg.preset, reg.spec, reg.host, reg.chain
    T, PS, L = C.types, C.per_slot, C.light
    t = T.types_for(preset)
    t_phase = time.perf_counter()
    C.tracing.configure(clock=_WallClock())
    calls = Calls(torch, K, TP, B, C, host, launches, card)
    state, head = chain.head_state, chain.head_root
    slot = int(state.slot)
    chain.slot_clock.set_slot(slot)
    members = sync_committee_members(C, state, preset)
    monitor = C.monitor.ValidatorMonitor()
    watched = set(members[:SYNC_MONITORED])
    for v in sorted(watched):
        monitor.register_validator(v)
    chain.validator_monitor = monitor
    out = {}

    t0 = time.perf_counter()
    msgs = {(): sync_messages(C, state, preset, spec, reg.secret_of, slot, head, host)}
    for bad in SYNC_FORGED_MESSAGES:
        msgs[bad] = sync_messages(C, state, preset, spec, reg.secret_of, slot, head, host,
                                  forge=bad)
    sign_s = time.perf_counter() - t0
    n = len(msgs[()])
    pools = sync_pools(C, preset)
    (res, _), step_calls = calls.step(
        "sync: messages", lambda: process_sync(C, chain, pools, messages=msgs[()]),
        want_calls=[n])
    verified, rejected = res["messages"]
    need(len(verified) == n and not rejected,
         f"sync: {len(verified)} of {n} messages verified, rejected {rejected[:3]}")
    message_sets = step_calls[0]["sets"]
    need(len({bytes(s.message) for s in message_sets}) == 1,
         "sync: the messages' sets sign more than one root")
    calls.replay("sync: messages", message_sets)
    seen = sum(1 for v in verified if int(v.message.validator_index) in watched)

    t0 = time.perf_counter()
    contribs = {(): sync_contributions(C, state, preset, spec, reg.secret_of, slot, head,
                                       pools.messages, host)}
    for bad in SYNC_FORGED_CONTRIBUTIONS:
        contribs[bad] = forge_contributions(C, state, preset, reg.secret_of, contribs[()],
                                            bad, host)
    sign_s += time.perf_counter() - t0
    m = len(contribs[()])
    (res, _), step_calls = calls.step(
        "sync: contributions", lambda: process_sync(C, chain, pools,
                                                   contributions=contribs[()]),
        want_calls=[3 * m])
    verified, rejected = res["contributions"]
    need(len(verified) == m and not rejected,
         f"sync: {len(verified)} of {m} contributions verified, rejected {rejected[:3]}")
    calls.replay("sync: contributions", step_calls[0]["sets"])

    # does a submit wait on the stream after the table and graphs phases?
    _, _, spin_ms = spin_timed(torch, lambda: None)
    submits = {}
    for spin in (False, True, False, True):
        fut, ms, _ = spin_timed(torch, lambda: C.api.verify_signature_sets_async(
            message_sets, seed=72, lane="sync", slot=slot), spin)
        need(fut.result() is True,
             "sync: the messages' batch rejected on the busy-card probe")
        submits.setdefault("spin" if spin else "idle", []).append(ms)
    waits = min(submits["spin"]) > spin_ms / 2
    out["busy_card"] = dict(spin_ms=spin_ms, submit_ms=submits, waits_on_stream=waits)
    log(f"sync: busy-card probe: a {n}-set sync-lane submit took "
        f"{[round(x, 1) for x in submits['idle']]} ms on an idle card and "
        f"{[round(x, 1) for x in submits['spin']]} ms behind a {spin_ms:.1f} ms spin: "
        f"{'it WAITS on the stream' if waits else 'host work, no wait on the stream'}; "
        f"card: {card}")

    for bad in SYNC_FORGED_MESSAGES:
        verified, _ = forged_run(
            C, calls, f"sync: messages with {len(bad)} forged", lambda items: (
                process_sync(C, chain, sync_pools(C, preset), messages=items)),
            msgs[bad], bad, "messages")
        seen += sum(1 for v in verified if int(v.message.validator_index) in watched)
    for bad in SYNC_FORGED_CONTRIBUTIONS:
        forged_run(C, calls, f"sync: contributions with {len(bad)} forged", lambda items: (
            process_sync(C, chain, sync_pools(C, preset), contributions=items)),
            contribs[bad], bad, "contributions")

    # the next block carries the contribution pool's sync aggregate
    aggregate = pools.contributions.get_sync_aggregate(t, slot, head)
    need(all(aggregate.sync_committee_bits), "sync: the sync aggregate is not full")
    pre = PS.process_slots(PS.clone_state(state), slot + 1, preset, spec)
    block, _ = produce_block(C, pre, preset, spec, reg.secret_of, host,
                             sync_aggregate=aggregate)
    need(block.message.body.sync_aggregate.as_ssz_bytes() == aggregate.as_ssz_bytes(),
         "sync: the block does not carry the pool's sync aggregate")

    # a light client bootstrapped at the genesis block follows the update
    # that this aggregate signs (the head at `slot`)
    boot = L.light_client_bootstrap(reg.genesis, preset)
    trusted = chain.genesis_block_root
    store = L.LightClientStore(trusted, boot, preset, spec,
                               bytes(state.genesis_validators_root))
    seed_light_client(C, store, boot.current_sync_committee, chain.pubkey_cache)
    update = L.light_client_optimistic_update(state, aggregate, slot + 1, preset)
    need(update.attested_header.tree_hash_root() == head,
         "sync: the update's attested header is not the head")
    domain = T.get_domain(state, T.DOMAIN_SYNC_COMMITTEE, slot // preset.slots_per_epoch,
                          preset)
    signing = T.SigningData(object_root=head, domain=domain).tree_hash_root()
    honest, forged_one = host.sign([([reg.secret_of(v) for v in members[1:]], signing),
                                    ([reg.secret_of(members[0])], wrong_root(signing))])
    forged = type(update).from_ssz_bytes(update.as_ssz_bytes())
    forged.sync_aggregate.sync_committee_signature = C.api.AggregateSignature.aggregate(
        [C.api.Signature.from_bytes(honest), C.api.Signature.from_bytes(forged_one)]
    ).to_bytes()

    def store_view():
        return (store.finalized_header.tree_hash_root(),
                store.optimistic_header.tree_hash_root(),
                store.previous_max_active_participants,
                store.current_max_active_participants)

    need(store_view() == (trusted, trusted, 0, 0), f"sync: fresh store {store_view()}")
    _, lc_calls = calls.step("sync: light-client update",
                             lambda: store.process_optimistic_update(update), want_calls=[1])
    calls.replay("sync: light-client update", lc_calls[0]["sets"])
    lc_keys = block_key_count(lc_calls[0]["sets"])
    need(B._common_table(lc_calls[0]["sets"]) is None,
         "sync: the light client's keys went down the table-gather route")
    after = store_view()
    need(after == (trusted, head, 0, preset.sync_committee_size),
         f"sync: light-client store {after}")

    def rejected_update():
        try:
            store.process_optimistic_update(forged)
        except L.LightClientError as e:
            return str(e)
        return None

    why, _ = calls.step("sync: light-client forged update", rejected_update,
                        want_calls=[1])
    need(why == "sync aggregate signature invalid" and store_view() == after,
         f"sync: forged light-client update: {why!r}, store {store_view()}")
    log(f"sync: light client bootstrapped at the genesis block, optimistic header "
        f"moved to the head at slot {slot} ({lc_keys} keys host-packed, no "
        f"table); the "
        f"update with one forged signature rejected, store unchanged; card: {card}")

    chain.slot_clock.set_slot(slot + 1)
    root, import_calls = calls.step(
        "sync: block import", lambda: chain.process_block(block),
        want_calls=[len(block.message.body.attestations) + 3])
    calls.replay("sync: block import", import_calls[0]["sets"])
    need(chain.head_root == root == block.message.tree_hash_root(),
         "sync: the block with the pool's sync aggregate is not the head")
    reg.twin.import_([block])
    reg.twin.expect("sync", chain, C)

    got = {v: monitor.validators[v].sync_signatures for v in watched}
    need(sum(got.values()) == seen,
         f"sync: the validator monitor counted {sum(got.values())} messages, want {seen}")
    oracle_wait_s = calls.check_oracle("sync")
    chain.validator_monitor = None
    out.update(calls.rows, messages=n, contributions=m, sign_s=sign_s,
               monitor=dict(registered=len(watched), sync_messages_seen=seen),
               oracle_wait_s=oracle_wait_s, head_slot=int(chain.head_state.slot),
               seconds=time.perf_counter() - t_phase)
    log(f"sync: {n} messages and {m} contributions verified, every verdict equal to "
        f"the cpu oracle's (waited {oracle_wait_s:.1f} s); the validator monitor saw "
        f"{seen} messages of its {len(watched)} validators; head at slot "
        f"{out['head_slot']} (held to the twin's at the end of the run); host sign "
        f"{sign_s:.1f} s; phase wall {out['seconds']:.1f} s; card: {card}")
    return out


# --- the pool phase: the naive and operation pools, speculation, reprocessing


POOL_BATCH = 64  # the processor's gossip batch: the warmed bucket (64, 4, 4)
POOL_AGGREGATES = 32  # gossip aggregates, the attestations phase's count
SPECULATE_FAMILIES = (
    "SPECULATE_PRECOMPUTE_ENTRIES", "SPECULATE_PRECOMPUTE_HITS",
    "SPECULATE_PRECOMPUTE_CORRECTIONS", "SPECULATE_PRECOMPUTE_MISSES",
    "SPECULATE_PRECOMPUTE_INVALIDATIONS", "SPECULATE_PREVERIFIED", "SPECULATE_CONFIRMS",
    "SPECULATE_CONFIRM_MISSES", "SPECULATE_MISMATCHES", "SPECULATE_IDLE_RUNS")


def speculated_aggregates(C, chain, state, preset, spec, secret_of, slot, host, source):
    """One SignedAggregateAndProof for each committee of `slot`: all bits
    set, over the AttestationData the chain produces for it, signed as the
    speculation's `source` signs it (so its arrival can be confirmed by
    lookup); the aggregator is the committee's first member whose
    selection proof selects it."""
    T = C.types
    t = T.types_for(preset)
    epoch = slot // preset.slots_per_epoch
    committees = C.context.ConsensusContext(preset, spec).committee_cache(
        state, epoch).get_all_committees_at_slot(slot)
    sel_root = T.SigningData(
        object_root=C.ssz.uint64.hash_tree_root(slot),
        domain=T.get_domain(state, T.DOMAIN_SELECTION_PROOF, epoch, preset),
    ).tree_hash_root()
    msgs = []
    for index, committee in enumerate(committees):
        data = chain.produce_attestation_data(slot, index)
        agg = None
        for c0 in range(0, len(committee), SELECTION_CHUNK):
            chunk = committee[c0:c0 + SELECTION_CHUNK]
            for m, proof in zip(chunk, host.sign([([secret_of(x)], sel_root)
                                                   for x in chunk])):
                if agg is None and C.att.is_aggregator(len(committee), proof, spec):
                    agg = (m, proof)
            if agg is not None:
                break
        need(agg is not None, f"pool: no aggregator in committee {index} of slot {slot}")
        att = t.Attestation(aggregation_bits=tuple(True for _ in committee), data=data,
                            signature=source(data, committee,
                                             attester_root(C, state, data, preset)))
        msgs.append(t.AggregateAndProof(aggregator_index=agg[0], aggregate=att,
                                        selection_proof=agg[1]))
    domain = T.get_domain(state, T.DOMAIN_AGGREGATE_AND_PROOF, epoch, preset)
    sigs = host.sign([([secret_of(m.aggregator_index)], T.compute_signing_root(m, domain))
                      for m in msgs])
    return [t.SignedAggregateAndProof(message=m, signature=s) for m, s in zip(msgs, sigs)]


def affine(point):
    return (point.x.n, point.y.n) if not point.inf else None


def phase_pool(torch, K, TP, B, C, reg, launches, card):
    """One slot's attestations on the card over the chain's head: its
    committees' unaggregated attestations through the processor into the
    naive pool, its aggregates and gossip aggregates into the operation
    pool; the gossip aggregates with speculation off and on (attached to
    the chain: committee aggregates on the card, corrections there); the
    idle pass and confirm-by-lookup; the block the pool packs; an
    aggregate that waits in the reprocess queue for that block. Every
    call against the cpu oracle, the head against the twin chain."""
    preset, spec, host, chain = reg.preset, reg.spec, reg.host, reg.chain
    T, PS, M = C.types, C.per_slot, C.metrics
    t = T.types_for(preset)
    spe = preset.slots_per_epoch
    t_phase = time.perf_counter()
    C.tracing.configure(clock=_WallClock())
    calls = Calls(torch, K, TP, B, C, host, launches, card)
    state, head = chain.head_state, chain.head_root
    slot = int(state.slot)
    chain.slot_clock.set_slot(slot)
    naive, ops = C.pool.NaiveAggregationPool(), C.pool.OperationPool(preset, spec)
    out = {}

    def sink(name, verified):
        for v in verified:
            if name == "unaggregated":
                naive.insert(v.attestation)
                ops.insert_attestation(v.attestation)
            else:
                ops.insert_attestation(v.signed_aggregate.message.aggregate)

    t0 = time.perf_counter()
    ahead = PS.process_slots(PS.clone_state(state), slot + 1, preset, spec)
    committees = C.context.ConsensusContext(preset, spec).committee_cache(
        state, slot // spe).get_all_committees_at_slot(slot)
    n = sum(len(c) for c in committees)
    unagg = gossip_unaggregated(C, ahead, preset, spec, reg.secret_of, slot, n, host)
    aggs = gossip_aggregates(C, state, preset, spec, reg.secret_of, POOL_AGGREGATES, host)
    sign_s = time.perf_counter() - t0

    (res, _), _ = calls.step(
        "pool: unaggregated", lambda: process_gossip(
            C, chain, unagg, sink=sink, max_batch=POOL_BATCH),
        want_calls=[min(POOL_BATCH, n - i) for i in range(0, n, POOL_BATCH)])
    got, rejected = verdicts(unagg, res["unaggregated"])
    need(len(got) == n and not rejected,
         f"pool: {len(got)} of {n} unaggregated verified, rejected {rejected}")
    datas = {a.data.tree_hash_root(): a.data for a in unagg}
    for data in datas.values():
        agg = naive.get_aggregate(t, data)
        need(agg is not None and all(agg.aggregation_bits),
             "pool: the naive pool's aggregate misses committee members")
        ops.insert_attestation(agg)
    log(f"pool: {n} unaggregated attestations of slot {slot} ({len(committees)} "
        f"committees) in batches of {POOL_BATCH} into the naive pool: {len(datas)} "
        f"full aggregates; card: {card}")

    (res_off, _), off_calls = calls.step(
        "pool: aggregates, speculation off", lambda: process_gossip(
            C, chain, aggregates=aggs, sink=sink), want_calls=[3 * len(aggs)])

    def source(data, members, root):
        return host.sign([([reg.secret_of(v) for v in members], root)])[0]

    idle = C.processor.BeaconProcessor(handlers={})
    t0 = time.perf_counter()
    sub = C.speculate.attach_speculation(chain, idle, signature_source=source,
                                         device_correction=True)
    attach_s = time.perf_counter() - t0
    entries = len(sub.precompute)
    table = B.committee_table()
    need(entries == len(table) and table.device_table().device.type == "cuda",
         f"pool: {entries} precompute entries, {len(table)} rows in the committee table")
    log(f"pool: attach_speculation refreshed {entries} committee entries of "
        f"{len(committees[0])} keys in {attach_s:.1f} s, parked on the card by "
        f"set_committee_aggregates; card: {card}")
    try:
        calls.step("pool: idle speculation", idle.run_until_idle, want_calls=[1] * len(
            committees))
        need(sub.verifier.stats["preverified"] == len(committees),
             f"pool: idle pass pre-verified {sub.verifier.stats['preverified']}")

        corrections = []
        correct = B.correct_aggregate_device

        def timed_correct(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            point = correct(*a, **kw)
            corrections.append((time.perf_counter() - t1) * 1e3)
            return point

        B.correct_aggregate_device = timed_correct
        try:
            (res_on, _), on_calls = calls.step(
                "pool: aggregates, speculation on", lambda: process_gossip(
                    C, chain, aggregates=aggs, sink=sink), want_calls=[3 * len(aggs)])
        finally:
            B.correct_aggregate_device = correct
        need(verdicts(aggs, res_on["aggregate"]) == verdicts(aggs, res_off["aggregate"]),
             "pool: verdicts differ with speculation on and off")
        got, rejected = verdicts(aggs, res_on["aggregate"])
        need(len(got) == len(aggs) and not rejected, f"pool: aggregates rejected {rejected}")
        keys_off = block_key_count(off_calls[0]["sets"])
        keys_on = block_key_count(on_calls[0]["sets"])
        need(keys_on < keys_off, f"pool: {keys_on} keys with speculation, {keys_off} without")
        checked = 0
        for entry in (e for es in sub.precompute._epochs.values() for e in es.values()):
            for bits, pk in entry.corrections.items():
                host_point = entry.full_point
                for m_pk, b in zip(entry.member_pks, bits):
                    if not b:
                        host_point = host_point + (-m_pk.point)
                need(affine(pk.point) == affine(host_point),
                     f"pool: corrected aggregate of committee {entry.index} at slot "
                     f"{entry.slot} differs from the host's")
                checked += 1
        need(corrections and checked == len(corrections),
             f"pool: {len(corrections)} device corrections, {checked} checked")
        # one more correction alone, replayed: its own launches
        entry = next(e for es in sub.precompute._epochs.values() for e in es.values()
                     if e.corrections)
        bits = next(iter(entry.corrections))
        absent = [m_pk for m_pk, b in zip(entry.member_pks, bits) if not b]
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        point = B.correct_aggregate_device(entry.full_pk, absent)
        correction_ms = (time.perf_counter() - t0) * 1e3
        correction_launches = dict(K.LAUNCHES)
        need(affine(point) == affine(entry.corrections[bits].point),
             "pool: the replayed correction differs")
        out["correction"] = dict(absent=len(absent), replayed_ms=correction_ms,
                                 launches=correction_launches)
        log(f"pool: one correction of {len(absent)} absent members replayed in "
            f"{correction_ms:.2f} ms, launches {correction_launches}; card: {card}")
        log(f"pool: {len(aggs)} gossip aggregates with speculation on: verdicts equal to "
            f"off, keys {keys_on} against {keys_off}; {len(corrections)} corrections on "
            f"the card ({min(corrections):.2f}-{max(corrections):.2f} ms each), each equal "
            f"to the host's full - absent; card: {card}")
        out["correction_ms"] = corrections

        chain.slot_clock.set_slot(slot + 1)
        confirmable = speculated_aggregates(C, chain, state, preset, spec, reg.secret_of,
                                            slot + 1, host, source)
        confirms0 = sub.verifier.stats["confirms"]
        (res, _), _ = calls.step(
            "pool: confirmed by lookup", lambda: process_gossip(
                C, chain, aggregates=confirmable, sink=sink),
            want_calls=[2 * len(confirmable)])
        got, rejected = verdicts(confirmable, res["aggregate"])
        need(len(got) == len(confirmable) and not rejected,
             f"pool: confirmable aggregates rejected {rejected}")
        confirmed = sub.verifier.stats["confirms"] - confirms0
        need(confirmed == len(confirmable), f"pool: {confirmed} confirmed by lookup")
        violations = C.adversary.audit(["speculation-poisoning"])
        need(not violations, f"pool: speculation-poisoning audit: {violations}")

        pre = PS.process_slots(PS.clone_state(state), slot + 1, preset, spec)
        t0 = time.perf_counter()
        packed = ops.get_attestations(pre)
        pack_ms = (time.perf_counter() - t0) * 1e3
        need(len(datas) <= len(packed) <= preset.max_attestations,
             f"pool: {len(packed)} attestations packed")
        block, post = produce_block(C, pre, preset, spec, reg.secret_of, host,
                                    attestations=packed)
        root = block.message.tree_hash_root()
        covered = len({v for a in packed for v in C.context.ConsensusContext(
            preset, spec).get_indexed_attestation(pre, a).attesting_indices})
        log(f"pool: get_attestations packed {len(packed)} of the pool's "
            f"{ops.num_attestations()} attestations in {pack_ms:.1f} ms, covering "
            f"{covered} validators; card: {card}")

        # an aggregate that arrives before its block waits in the reprocess queue
        ahead2 = PS.process_slots(PS.clone_state(post), slot + 2, preset, spec)
        late = gossip_aggregates(C, ahead2, preset, spec, reg.secret_of, 1, host)
        need(bytes(late[0].message.aggregate.data.beacon_block_root) == root,
             "pool: the late aggregate does not name the packed block")
        queue = C.reprocess.ReprocessQueue(delay_s=float(spec.seconds_per_slot),
                                           clock=lambda: float(chain.current_slot))
        res, _ = process_gossip(C, chain, aggregates=late)
        need(res["aggregate"][1] == [(late[0], "unknown head block")],
             f"pool: late aggregate {res['aggregate'][1]}")
        need(queue.defer("gossip_aggregate", late[0], root, late[0].tree_hash_root()),
             "pool: the reprocess queue refused the late aggregate")

        got_root, import_calls = calls.step(
            "pool: packed block import", lambda: chain.process_block(block),
            want_calls=[len(packed) + 3])
        need(chain.head_root == got_root == root, "pool: the packed block is not the head")
        calls.replay("pool: packed block import", import_calls[0]["sets"])
        released = queue.on_block_imported(root)
        need([q for q, _ in released] == ["gossip_aggregate"] and len(queue) == 0,
             f"pool: reprocess released {released}")
        (res, _), _ = calls.step(
            "pool: reprocessed aggregate", lambda: process_gossip(
                C, chain, aggregates=[item for _, item in released]))
        got, rejected = verdicts(late, res["aggregate"])
        need(len(got) == 1 and not rejected, f"pool: reprocessed aggregate {rejected}")
        counts = {name: getattr(M, name).value for name in SPECULATE_FAMILIES}
        stats = dict(precompute=dict(sub.precompute.stats),
                     verifier=dict(sub.verifier.stats))
    finally:
        sub.detach()
    reg.twin.import_([block])
    reg.twin.expect("pool", chain, C)
    oracle_wait_s = calls.check_oracle("pool")
    out.update(calls.rows, unaggregated=n, aggregates=len(aggs), entries=entries,
               attach_s=attach_s, keys_off=keys_off, keys_on=keys_on,
               packed=len(packed), covered=covered, pack_ms=pack_ms,
               speculate=counts, speculate_stats=stats, reprocess=dict(queue.stats),
               sign_s=sign_s, oracle_wait_s=oracle_wait_s,
               head_slot=int(chain.head_state.slot),
               seconds=time.perf_counter() - t_phase)
    log(f"pool: speculation counts {json.dumps(counts)}; stats {json.dumps(stats)}; "
        f"reprocess {json.dumps(queue.stats)}")
    log(f"pool: every verdict equal to the cpu oracle's (waited {oracle_wait_s:.1f} s); "
        f"head at slot {out['head_slot']} (held to the twin's at the end of the run); "
        f"host sign {sign_s:.1f} s; phase wall {out['seconds']:.1f} s; card: {card}")
    return out


# --- the genesis phase: genesis from eth1 deposits, the EF-vector walker


GENESIS_DEPOSITS = 64  # ChainSpec.minimal's min_genesis_active_validator_count
# the forged run and the EF initialization case initialize from the first
# GENESIS_SMALL honest deposits (8 one-set calls each, where 64 took ~20 s
# each on the card; cut to keep the default run under ~840 s once the
# scenario phase came); the honest genesis keeps all 64
GENESIS_SMALL = 8
GENESIS_FORGED_AT = 5  # the forged deposit's place in the forged run's list
ETH1_BLOCK_HASH = b"\x42" * 32
EF_KINDS = ("verify", "fast_aggregate_verify", "aggregate_verify", "batch_verify")


def genesis_deposit_data(C, spec, n, host, sign=True, forged=()):
    """DepositData of interop keys 0..n-1 at a full stake, with the
    withdrawal credentials interop genesis gives them, each signed by its
    key over the deposit domain (signatures from `host`); an index in
    `forged` signs a wrong root; `sign=False` puts the infinity signature
    (for the `fake` backend)."""
    T, api = C.types, C.api
    keys = [api.PublicKey(C.curve.Point(C.fields.Fp(x), C.fields.Fp(y))).to_bytes()
            for x, y in host.map(_pubkey_xy, range(n))]
    datas = [T.DepositData(
        pubkey=pk, withdrawal_credentials=b"\x00" + hashlib.sha256(pk).digest()[1:],
        amount=spec.max_effective_balance, signature=api.INFINITY_SIGNATURE)
        for pk in keys]
    if sign:
        domain = T.compute_domain(T.DOMAIN_DEPOSIT, spec.genesis_fork_version, bytes(32))
        jobs = []
        for i, d in enumerate(datas):
            root = T.compute_signing_root(T.DepositMessage(
                pubkey=d.pubkey, withdrawal_credentials=d.withdrawal_credentials,
                amount=d.amount), domain)
            jobs.append(([T.interop_secret_key(i).scalar],
                         wrong_root(root) if i in forged else root))
        for d, sig in zip(datas, host.sign(jobs)):
            d.signature = sig
    return datas


def deposit_list(C, datas):
    """The deposit contract's tree over `datas` and each deposit with its
    branch against the root of the deposits up to it, as genesis replays
    them. Returns (tree, deposits)."""
    tree = C.deposit_tree.DepositDataTree()
    for d in datas:
        tree.push(d)
    return tree, [tree.deposit(i, d, i + 1) for i, d in enumerate(datas)]


def genesis_eth1_blocks(spec, block_hash, n):
    """(hash, timestamp, deposit count) of the eth1 blocks a genesis
    service has cached, oldest first: one too early, one with too few
    deposits, the first that qualifies (`block_hash` at min_genesis_time
    with n deposits) and a later one."""
    t = spec.min_genesis_time
    early = t - spec.genesis_delay - 1
    return [(b"\x01" * 32, early, n), (b"\x02" * 32, t, n // 2),
            (block_hash, t, n), (b"\x03" * 32, t + 14, n)]


def _hex(b) -> str:
    return "0x" + bytes(b).hex()


def _ef_write(case_dir, files):
    """One case directory of the official layout: `files` maps a name to
    bytes (written ssz_snappy-compressed by the port's snappy) or to a
    plain value (written as JSON, which every YAML reader reads)."""
    from lighthouse_tpu_torch.network.snappy import compress

    os.makedirs(case_dir, exist_ok=True)
    for name, value in files.items():
        if isinstance(value, bytes):
            with open(os.path.join(case_dir, name), "wb") as f:
                f.write(compress(value))
        else:
            with open(os.path.join(case_dir, name), "w") as f:
                json.dump(value, f)


def ef_bls_cases(C, host):
    """{handler: {case: data.yaml's content}} covering every kind of case
    the official BLS suite has for the four handlers: valid, a wrong
    pubkey, a tampered signature (its last 4 bytes 0xff, as the official
    generator tampers), the infinity pubkey with the infinity signature,
    no pubkeys with the infinity signature and with an all-zero one, an
    extra pubkey, and a batch with one invalid set; signed by the port's
    host oracle (`host`)."""
    api, T = C.api, C.types
    scalars = [T.interop_secret_key(1000 + i).scalar for i in range(4)]
    pks = [_hex(api.PublicKey(C.curve.Point(C.fields.Fp(x), C.fields.Fp(y))).to_bytes())
           for x, y in host.map(_pubkey_xy, range(1000, 1004))]
    msgs = [bytes(32), b"\x56" * 32, b"\xab" * 32]
    one = host.sign([([scalars[i]], msgs[i]) for i in range(3)])
    fast = host.sign([(scalars[:3], msgs[1])])[0]
    agg = api.AggregateSignature.aggregate(
        [api.Signature.from_bytes(b) for b in one]).to_bytes()
    inf_pk, inf_sig = _hex(b"\xc0" + bytes(47)), _hex(api.INFINITY_SIGNATURE)

    def tampered(sig):
        return _hex(bytes(sig)[:-4] + b"\xff" * 4)

    m = [_hex(x) for x in msgs]
    return {
        "verify": {
            "valid": dict(input=dict(pubkey=pks[0], message=m[0], signature=_hex(one[0])),
                          output=True),
            "wrong_pubkey": dict(input=dict(pubkey=pks[1], message=m[0],
                                            signature=_hex(one[0])), output=False),
            "tampered_signature": dict(input=dict(pubkey=pks[0], message=m[0],
                                                  signature=tampered(one[0])), output=False),
            "infinity_pubkey_and_infinity_signature": dict(
                input=dict(pubkey=inf_pk, message=m[0], signature=inf_sig), output=False),
        },
        "fast_aggregate_verify": {
            "valid": dict(input=dict(pubkeys=pks[:3], message=m[1], signature=_hex(fast)),
                          output=True),
            "extra_pubkey": dict(input=dict(pubkeys=pks, message=m[1],
                                            signature=_hex(fast)), output=False),
            "tampered_signature": dict(input=dict(pubkeys=pks[:3], message=m[1],
                                                  signature=tampered(fast)), output=False),
            "infinity_pubkey": dict(input=dict(pubkeys=pks[:2] + [inf_pk], message=m[1],
                                               signature=_hex(fast)), output=False),
            "na_pubkeys_and_infinity_signature": dict(
                input=dict(pubkeys=[], message=m[1], signature=inf_sig), output=False),
            "na_pubkeys_and_zero_signature": dict(
                input=dict(pubkeys=[], message=m[1], signature=_hex(bytes(96))),
                output=False),
        },
        "aggregate_verify": {
            "valid": dict(input=dict(pubkeys=pks[:3], messages=m, signature=_hex(agg)),
                          output=True),
            "tampered_signature": dict(input=dict(pubkeys=pks[:3], messages=m,
                                                  signature=tampered(agg)), output=False),
            "infinity_pubkey": dict(input=dict(pubkeys=pks[:2] + [inf_pk], messages=m,
                                               signature=_hex(agg)), output=False),
            "na_pubkeys_and_infinity_signature": dict(
                input=dict(pubkeys=[], messages=[], signature=inf_sig), output=False),
            "na_pubkeys_and_zero_signature": dict(
                input=dict(pubkeys=[], messages=[], signature=_hex(bytes(96))),
                output=False),
        },
        "batch_verify": {
            "valid": dict(input=dict(pubkeys=pks[:3], messages=m,
                                     signatures=[_hex(x) for x in one]), output=True),
            "invalid_set": dict(input=dict(pubkeys=pks[:3], messages=m,
                                           signatures=[_hex(one[0]), _hex(one[2]),
                                                       _hex(one[2])]), output=False),
            "tampered_signature": dict(input=dict(
                pubkeys=pks[:3], messages=m,
                signatures=[_hex(one[0]), tampered(one[1]), _hex(one[2])]), output=False),
        },
    }


def write_ef_tree(C, root, host, genesis=None, valid_state=None):
    """An EF test tree in the official layout under `root`: the BLS cases
    of `ef_bls_cases` at tests/general/phase0/bls/<handler>/bls/<case>/,
    and, with `genesis` = (eth1 block hash, eth1 timestamp, deposits, the
    state genesis made of them, spec), its genesis cases under
    tests/minimal/phase0/genesis/: initialization from those deposits,
    validity of `valid_state` (by default that state) and of the same
    state one second too early. Returns {case directory: the BLS case's
    data} (genesis cases: None)."""
    cases = {}
    bls = ef_bls_cases(C, host)
    for handler, kinds in bls.items():
        for kind, data in kinds.items():
            d = os.path.join(root, "tests", "general", "phase0", "bls", handler, "bls",
                             f"{handler}_{kind}")
            _ef_write(d, {"data.yaml": data})
            cases[d] = data
    if genesis is not None:
        block_hash, timestamp, deposits, state, spec = genesis
        base = os.path.join(root, "tests", "minimal", "phase0", "genesis")
        d = os.path.join(base, "initialization", "pyspec_tests", "from_eth1_deposits")
        _ef_write(d, {"eth1.yaml": dict(eth1_block_hash=_hex(block_hash),
                                        eth1_timestamp=int(timestamp)),
                      "meta.yaml": dict(deposits_count=len(deposits)),
                      "state.ssz_snappy": state.as_ssz_bytes(),
                      **{f"deposits_{i}.ssz_snappy": dep.as_ssz_bytes()
                         for i, dep in enumerate(deposits)}})
        cases[d] = None
        valid_state = state if valid_state is None else valid_state
        early = C.per_slot.clone_state(valid_state)
        early.genesis_time = spec.min_genesis_time - 1
        for name, st, valid in (("valid", valid_state, True), ("too_early", early, False)):
            d = os.path.join(base, "validity", "pyspec_tests", name)
            _ef_write(d, {"genesis.ssz_snappy": st.as_ssz_bytes(), "is_valid.yaml": valid})
            cases[d] = None
    return cases


def ef_case_call(C, data, handler):
    """The port's api call a BLS case makes on its inputs (as the walker
    makes it), for a case whose inputs all decode."""
    api = C.api
    inp = data["input"]

    def b(h):
        return bytes.fromhex(h[2:])

    if handler == "verify":
        return lambda: api.verify(api.Signature.from_bytes(b(inp["signature"])),
                                  [api.PublicKey.from_bytes(b(inp["pubkey"]))],
                                  b(inp["message"]))
    pks = [api.PublicKey.from_bytes(b(p)) for p in inp["pubkeys"]]
    if handler == "fast_aggregate_verify":
        return lambda: api.verify(api.Signature.from_bytes(b(inp["signature"])), pks,
                                  b(inp["message"]))
    if handler == "aggregate_verify":
        return lambda: api.aggregate_verify(api.Signature.from_bytes(b(inp["signature"])),
                                            pks, [b(x) for x in inp["messages"]])
    sets = [api.SignatureSet.single_pubkey(api.Signature.from_bytes(b(s)), pk, b(m))
            for pk, m, s in zip(pks, inp["messages"], inp["signatures"])]
    return lambda: api.verify_signature_sets(sets, seed=1)


def genesis_service(tree, datas, blocks):
    """The three attributes `try_genesis_from_eth1` reads of an eth1
    service: its cached blocks, its deposit tree and its deposit data."""
    from types import SimpleNamespace

    return SimpleNamespace(
        block_cache=[SimpleNamespace(hash=h, timestamp=t, deposit_count=n)
                     for h, t, n in blocks],
        deposit_tree=tree, _deposit_data=datas)


def phase_genesis(torch, K, TP, B, C, host, launches, card):
    """Genesis from eth1 deposits on the card (MINIMAL): 64 interop
    deposits through try_genesis_from_eth1 over a stub service (which
    initializes from them), each new key's proof of possession one
    one-set call, the state valid and equal to the `fake` backend's; a
    forged deposit among the first GENESIS_SMALL honest ones left out, the
    registry theirs; an EF tree of BLS and genesis cases (initialization
    from those GENESIS_SMALL deposits, validity of the 64-deposit state)
    through the port's walker. Every call against the cpu oracle. (The
    honest deposits run once, through the service: a separate
    initialize_beacon_state_from_eth1 run of the same 64 calls was cut to
    keep the default run under its limit.)"""
    T, G, api = C.types, C.genesis, C.api
    preset, spec = T.MINIMAL, T.ChainSpec.minimal()
    need(spec.min_genesis_active_validator_count == GENESIS_DEPOSITS,
         f"genesis: minimal spec wants {spec.min_genesis_active_validator_count}")
    t_phase = time.perf_counter()
    datas = genesis_deposit_data(C, spec, GENESIS_DEPOSITS + 1, host,
                                 forged=(GENESIS_DEPOSITS,))
    honest = datas[:GENESIS_DEPOSITS]
    tree, deposits = deposit_list(C, honest)
    small = honest[:GENESIS_SMALL]
    _, small_deposits = deposit_list(C, small)
    bad_datas = small[:GENESIS_FORGED_AT] + [datas[-1]] + small[GENESIS_FORGED_AT:]
    _, bad_deposits = deposit_list(C, bad_datas)
    build_s = time.perf_counter() - t_phase
    log(f"genesis: {len(datas)} interop deposits signed with their proofs in "
        f"{build_s:.1f} s")

    calls, out = Calls(torch, K, TP, B, C, host, launches, card), {}
    ts = spec.min_genesis_time

    def initialize(deps):
        return G.initialize_beacon_state_from_eth1(ETH1_BLOCK_HASH, ts, deps, preset, spec)

    one = [C.signature_sets.deposit_signature_set(honest[0], spec)]
    calls.step("genesis: deposit", lambda: api.verify_signature_sets(one), [1])
    calls.replay("genesis: deposit", one)
    service = genesis_service(tree, honest, genesis_eth1_blocks(
        spec, ETH1_BLOCK_HASH, GENESIS_DEPOSITS))
    state, _ = calls.step("genesis: try_genesis_from_eth1",
                          lambda: G.try_genesis_from_eth1(service, preset, spec),
                          [1] * GENESIS_DEPOSITS)
    need(state is not None and calls.rows["genesis: try_genesis_from_eth1"]["verdicts"]
         == [True] * GENESIS_DEPOSITS, "genesis: no state, or a deposit rejected")
    need(len(state.validators) == GENESIS_DEPOSITS and
         G.is_valid_genesis_state(state, preset, spec), "genesis: state not valid")
    api.set_backend("fake")
    try:
        fake_root = initialize(deposits).tree_hash_root()
        small_state = initialize(small_deposits)
    finally:
        api.set_backend("torch_cuda")
    need(state.tree_hash_root() == fake_root, "genesis: state root differs from the "
         "fake backend's")

    bad, _ = calls.step("genesis: forged deposit", lambda: initialize(bad_deposits),
                        [1] * (GENESIS_SMALL + 1))
    want = [True] * GENESIS_SMALL
    want.insert(GENESIS_FORGED_AT, False)
    need(calls.rows["genesis: forged deposit"]["verdicts"] == want,
         "genesis: forged run's verdicts")
    need([v.as_ssz_bytes() for v in bad.validators] ==
         [v.as_ssz_bytes() for v in small_state.validators] and
         list(bad.balances) == list(small_state.balances),
         "genesis: the forged deposit changed the registry")

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ef",
                        str(os.getpid()))
    if os.path.isdir(root):
        import shutil

        shutil.rmtree(root)
    cases = write_ef_tree(C, root, host, genesis=(ETH1_BLOCK_HASH, ts, small_deposits,
                                                  small_state, spec), valid_state=state)
    for handler in EF_KINDS:
        d = os.path.join(root, "tests", "general", "phase0", "bls", handler, "bls",
                         f"{handler}_valid")
        label = f"genesis: {handler}"
        fn = ef_case_call(C, cases[d], handler)
        ok, step_calls = calls.step(label, fn, [1 if handler != "batch_verify" else 3])
        need(ok is True, f"{label}: valid case rejected")
        torch.cuda.synchronize()
        t = time.perf_counter()
        need(fn() is True, f"{label}: replay rejected")
        calls.rows[label]["replayed_ms"] = (time.perf_counter() - t) * 1e3
    results, _ = calls.step("genesis: EF cases", lambda: C.ef_tests.run_tree(root))
    bad_cases = [r for r in results if not r.ok]
    need(len(results) == len(cases) and not bad_cases,
         f"genesis: EF walker: {len(results)} of {len(cases)} cases, failed {bad_cases}")
    ef_calls = calls.rows["genesis: EF cases"]
    oracle_wait_s = calls.check_oracle("genesis")
    kinds = {"deposit": "genesis: deposit", **{h: f"genesis: {h}" for h in EF_KINDS}}
    for kind, label in kinds.items():
        row = calls.rows[label]
        log(f"genesis: {kind}: {row['calls'][0]} sets, {row['keys'][0]} keys, "
            f"{row['pairs'][0]} pairs; first call {row['seconds']:.3f} s, replayed "
            f"{row['replayed_ms']:.1f} ms; card: {card}")
        out[kind] = dict(sets=row["calls"][0], keys=row["keys"][0], pairs=row["pairs"][0],
                         first_call_s=row["seconds"], replayed_ms=row["replayed_ms"])
    init = calls.rows["genesis: try_genesis_from_eth1"]
    out.update(
        deposits=GENESIS_DEPOSITS, build_s=build_s, genesis_s=init["seconds"],
        forged_s=calls.rows["genesis: forged deposit"]["seconds"],
        ef_cases=len(results), ef_calls=len(ef_calls["calls"]),
        ef_s=ef_calls["seconds"], oracle_wait_s=oracle_wait_s,
        seconds=time.perf_counter() - t_phase)
    log(f"genesis: try_genesis_from_eth1 over {GENESIS_DEPOSITS} deposits in "
        f"{init['seconds']:.3f} s ({GENESIS_DEPOSITS} one-set calls), the state valid "
        f"and its root the fake backend's; a forged deposit among {GENESIS_SMALL} left "
        f"out, the registry the honest ones' ({out['forged_s']:.3f} s); "
        f"{len(results)} EF cases ok "
        f"({len(ef_calls['calls'])} backend calls, {out['ef_s']:.3f} s); every verdict "
        f"equal to the cpu oracle's (waited {oracle_wait_s:.1f} s); phase wall "
        f"{out['seconds']:.1f} s; card: {card}")
    return out


# --- the finality phase: the chain harness past finality over the native store


FINALITY_VALIDATORS = 64
FINALITY_MAX_EPOCHS = 5
FINALITY_SPANS = ("block_transition", "state_root", "fork_choice", "block_import")
# the error the JAX package's harness chain gives for a block whose
# attestation signature is forged (tests/test_torch_harness.py holds both)
FORGED_BLOCK_ERROR = "bulk signature check failed"
STORE_FAMILIES = ("STORE_NATIVE_REPLAYED", "STORE_NATIVE_ROLLED_BACK",
                  "STORE_NATIVE_TRUNCATED", "STORE_FSCK_RUNS", "STORE_FSCK_FAILURES")


def forged_harness_block(C, h, slot):
    """A block at `slot` on the harness chain's head whose first
    attestation carries a signature over a wrong root (a valid point):
    (signed block, parent root)."""
    T, PS = C.types, C.per_slot
    parent_root = h.chain.head_root
    parent = h.chain._states[parent_root]
    adv = PS.process_slots(PS.clone_state(parent), slot, h.preset, h.spec)
    atts = h.producer.attestations_for_slot(adv, slot - 1)
    atts[0].signature = T.interop_secret_key(0).sign(wrong_root(bytes(32))).to_bytes()
    signed, _ = h.producer.produce_block(slot, atts, base_state=parent)
    return signed, parent_root


def phase_finality(torch, K, TP, B, C, host, launches, card, shared=None):
    """The port's BeaconChainHarness (MINIMAL, 64 validators, signing
    with the host oracle) on the card over a NativeStore: extend_chain
    until the chain finalizes, every block imported with VERIFY_BULK on
    torch_cuda; the head and checkpoints against a NO_VERIFICATION twin;
    a forged block rejected; fsck clean; the store reopened and the chain
    resumed from it at the same head and finalized checkpoint. Leaves the
    genesis and the blocks in `shared["finality"]` for the network
    phase's wire part."""
    T, M = C.types, C.metrics
    preset, spec = T.MINIMAL, T.ChainSpec.minimal()
    spe = preset.slots_per_epoch
    t_phase = time.perf_counter()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "finality",
                        f"chain-{os.getpid()}.db")
    if os.path.exists(path):
        os.remove(path)
    store0 = {name: getattr(M, name).value for name in STORE_FAMILIES}
    kv = C.native_kv.NativeStore(path)
    h = C.harness.BeaconChainHarness(FINALITY_VALIDATORS, preset, spec, sign=True, kv=kv)
    need(h.chain.pubkey_cache.device_table().device.type == "cuda" and
         h.strategy == C.per_block.BlockSignatureStrategy.VERIFY_BULK,
         "finality: the harness chain is not on the card or does not verify")
    setup_s = time.perf_counter() - t_phase
    genesis = C.per_slot.clone_state(h.producer.state)

    blocks, host_s, verify_s = [], [], []
    produce, attest = h.producer.produce_block, h.producer.attestations_for_slot
    verify = C.bsv.BlockSignatureVerifier.verify

    def produce_timed(*args, **kwargs):
        t = time.perf_counter()
        signed, post = produce(*args, **kwargs)
        host_s.append(time.perf_counter() - t)
        blocks.append(signed)
        return signed, post

    def attest_timed(*args, **kwargs):
        t = time.perf_counter()
        out = attest(*args, **kwargs)
        host_s.append(time.perf_counter() - t)
        return out

    def verify_timed(self, *args, **kwargs):
        t = time.perf_counter()
        out = verify(self, *args, **kwargs)
        verify_s.append(time.perf_counter() - t)
        return out

    def extend():
        while h.finalized_epoch() < 1:
            need(h.chain.head_state.slot < FINALITY_MAX_EPOCHS * spe,
                 f"finality: not finalized within {FINALITY_MAX_EPOCHS} epochs")
            h.extend_chain(1)
        return h.chain.head_root

    C.tracing.configure(clock=_WallClock())
    C.tracing.default_tracer().reset()
    calls = Calls(torch, K, TP, B, C, host, launches, card)
    h.producer.produce_block, h.producer.attestations_for_slot = produce_timed, attest_timed
    C.bsv.BlockSignatureVerifier.verify = verify_timed
    try:
        head, ext_calls = calls.step("finality: extend_chain", extend)
    finally:
        h.producer.produce_block, h.producer.attestations_for_slot = produce, attest
        C.bsv.BlockSignatureVerifier.verify = verify
    spans = span_ms(C, *FINALITY_SPANS)
    n = len(blocks)
    if shared is not None:
        shared["finality"] = (genesis, list(blocks))
    row = calls.rows["finality: extend_chain"]
    need(len(ext_calls) == n and all(row["verdicts"]),
         f"finality: {len(ext_calls)} backend calls for {n} blocks, verdicts "
         f"{row['verdicts']}")
    calls.replay("finality: extend_chain", ext_calls[-1]["sets"])

    twin_t = time.perf_counter()
    twin = C.beacon_chain.BeaconChain(
        C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), genesis, preset, spec)
    NOV = C.per_block.BlockSignatureStrategy.NO_VERIFICATION
    for b in blocks:
        twin.slot_clock.set_slot(b.message.slot)
        twin.process_block(b, strategy=NOV)
    need(chain_view(C, h.chain) == chain_view(C, twin),
         "finality: head or checkpoints differ from the NO_VERIFICATION twin's")
    twin_s = time.perf_counter() - twin_t

    slot = int(h.chain.head_state.slot) + 1
    forged, parent_root = forged_harness_block(C, h, slot)

    def forged_import():
        h.chain.slot_clock.set_slot(slot)
        try:
            h.chain.process_block(forged, strategy=h.strategy)
        except C.beacon_chain.BlockError as e:
            return str(e)
        return None

    err, _ = calls.step("finality: forged block", forged_import, [
        len(forged.message.body.attestations) + 2])
    need(err == FORGED_BLOCK_ERROR and h.chain.head_root == parent_root == head,
         f"finality: forged block: error {err!r}, want {FORGED_BLOCK_ERROR!r}; head "
         f"{'kept' if h.chain.head_root == head else 'moved'}")
    need(calls.rows["finality: forged block"]["verdicts"] == [False],
         "finality: the forged block's call accepted")

    issues = C.fsck.run_fsck(h.chain.store)
    need(issues == [], f"finality: fsck: {[str(i) for i in issues]}")
    view = (h.chain.head_root, h.chain.finalized_checkpoint)
    kv.close()
    reopen_t = time.perf_counter()
    kv2 = C.native_kv.NativeStore(path)
    try:
        resumed = C.beacon_chain.BeaconChain.from_store(
            C.hot_cold.HotColdDB(kv2, preset, spec), preset, spec)
        need((resumed.head_root, resumed.finalized_checkpoint) == view,
             "finality: the chain resumed from the reopened store elsewhere")
        issues2 = C.fsck.run_fsck(resumed.store)
        need(issues2 == [], f"finality: fsck after reopen: {[str(i) for i in issues2]}")
        entries = len(kv2)
    finally:
        kv2.close()
    reopen_s = time.perf_counter() - reopen_t
    oracle_wait_s = calls.check_oracle("finality")
    store = {name: getattr(M, name).value - store0[name] for name in STORE_FAMILIES}
    fin, jus = h.chain.finalized_checkpoint, h.chain.justified_checkpoint
    verify_ms = sum(verify_s) * 1e3 / n
    per_block = dict(
        seconds=row["seconds"] / n, production_s=sum(host_s) / n, verify_ms=verify_ms,
        transition_ms=(spans["block_transition"] + spans["state_root"]) / n - verify_ms,
        fork_choice_ms=spans["fork_choice"] / n,
        import_rest_ms=(spans["block_import"] - spans["block_transition"]
                        - spans["state_root"] - spans["fork_choice"]) / n)
    log(f"finality: {n} blocks (slots 1-{slot - 1}) imported with VERIFY_BULK, one call "
        f"each of {sorted(set(row['calls']))} sets ({sorted(set(row['pairs']))} pairs); "
        f"head at slot {slot - 1}, justified epoch {jus[0]}, finalized epoch {fin[0]}, "
        f"equal to the twin's ({twin_s:.1f} s); a block: {per_block['seconds']:.3f} s, "
        f"production (host signing, post-state root) {per_block['production_s']:.3f} "
        f"s, verify {per_block['verify_ms']:.1f} ms, the rest of the transition + "
        f"state root "
        f"{per_block['transition_ms']:.1f} ms, fork choice "
        f"{per_block['fork_choice_ms']:.1f} ms, the rest of the import (the store "
        f"write, the caches) {per_block['import_rest_ms']:.1f} ms; replayed "
        f"{row['replayed_ms']:.1f} ms; card: {card}")
    log(f"finality: the forged block rejected ({err}), head kept; fsck clean before "
        f"close and after reopen; the reopened NativeStore ({entries} entries) resumed "
        f"the chain at the same head and finalized checkpoint in {reopen_s:.2f} s; "
        f"store counts {json.dumps(store)}; every verdict equal to the cpu oracle's "
        f"(waited {oracle_wait_s:.1f} s); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; card: {card}")
    return dict(blocks=n, head_slot=slot - 1, justified_epoch=int(jus[0]),
                finalized_epoch=int(fin[0]), setup_s=setup_s, per_block=per_block,
                extend_s=row["seconds"], replayed_ms=row["replayed_ms"], twin_s=twin_s,
                reopen_s=reopen_s, store=store, oracle_wait_s=oracle_wait_s,
                seconds=time.perf_counter() - t_phase)


# --- the merge phase: blocks past the merge over the engine API, the builder, eth1


MERGE_BLOCKS = 3  # the merge-transition block at BLOCK_SLOT + 1 (32) and two more
MERGE_FORGED = 7  # the forged block's attestation signed over a wrong root
MERGE_SPANS = ("block_transition", "state_root", "fork_choice", "block_import")
MERGE_VALIDATORS = 64  # the MINIMAL part's registry (ChainSpec.interop's genesis count)
# the MINIMAL part's fork crossing: phase0, altair at epoch 1, bellatrix at
# epoch 2 and its first two payload blocks (a third epoch was cut to keep the
# default run under its limit)
MERGE_CROSSING_SLOTS = 2 * 8 + 1
MERGE_JWT_SECRET = bytes(range(32))  # the engine rig's HS256 key
RIG_TIMEOUT_S = 5.0  # every rig client's socket timeout
# the error the builder path gives a bid whose signature does not verify
BAD_BID_ERROR = "bad builder bid signature"


def engine_rig(C, types, stack):
    """The execution side of a merge chain: a MockExecutionEngine behind
    an EngineRpcServer on a free port of localhost (JWT checked on every
    request), and an ExecutionLayer that reaches it over HttpJsonRpcEngine,
    building the transition payload on the mock's terminal block. No
    retry policy: an engine that cannot be reached fails the import. The
    server is stopped by `stack`. Every notify_new_payload's (block hash,
    status, ms) is appended to `el.notified`."""
    X = C.execution_layer
    engine = X.MockExecutionEngine(types)
    key = X.JwtKey(MERGE_JWT_SECRET)
    server = X.EngineRpcServer(engine, key).start()
    stack.callback(server.stop)
    el = X.ExecutionLayer(
        X.HttpJsonRpcEngine(server.url, key, types.ExecutionPayload, retries=1,
                            timeout_s=RIG_TIMEOUT_S),
        pre_merge_parent_hash=engine.genesis_hash)
    notify, el.notified = el.notify_new_payload, []

    def timed(payload):
        t = time.perf_counter()
        status = notify(payload)
        el.notified.append((bytes(payload.block_hash), status,
                            (time.perf_counter() - t) * 1e3))
        return status

    el.notify_new_payload = timed
    return engine, server, el


def notified_since(C, el, n, want, label):
    """The notifies after the first `n`: each status `want` (VERIFIED for
    honest payloads). Returns their engine round-trip ms."""
    got = el.notified[n:]
    need(got and all(s is want for _, s, _ in got),
         f"{label}: payload statuses {[s.value for _, s, _ in got]}, want {want.value}")
    return [ms for _, _, ms in got]


def merge_spec(C, engine):
    """MAINNET's merge chain: altair at genesis (so the registry's genesis
    serves), bellatrix at epoch 1, and the mock engine's terminal block
    as the spec's terminal block hash, which validate_merge_block holds
    the transition payload's parent to."""
    import dataclasses

    return dataclasses.replace(
        C.types.ChainSpec.interop(altair_fork_epoch=0, bellatrix_fork_epoch=1),
        terminal_block_hash=engine.genesis_hash, terminal_block_hash_activation_epoch=0)


def merge_mainnet(torch, B, C, reg, calls, card, twin_worker):
    """Part (a): the merge-transition block and two payload-bearing
    blocks at MAINNET over the registry's 16,384 validators, each
    imported with one backend call on the card, their payloads VERIFIED
    by the engine over HTTP and JWT; a block with a tampered payload hash
    and one with a forged attestation signature rejected. Returns the
    part's record and the NO_VERIFICATION twin (`Twin`, in `twin_worker`)
    of its chain, to be checked."""
    T, PS, X = C.types, C.per_slot, C.execution_layer
    preset, host = reg.preset, reg.host
    t = T.types_for(preset)
    out = {}
    with contextlib.ExitStack() as stack:
        engine, server, el = engine_rig(C, t, stack)
        # the registry's genesis serves the merge spec: neither the bellatrix
        # epoch nor the terminal block hash enters the interop genesis
        # (tests/test_torch_chip_smoke.py holds the two roots equal; the
        # MAINNET genesis computed again here cost ~15-17 s of host work and
        # was cut to keep the default run under its limit)
        spec = merge_spec(C, engine)
        twin = Twin(reg.genesis_ssz, preset, spec, reg.checked_xy, twin_worker)
        t0 = time.perf_counter()
        chain = C.beacon_chain.BeaconChain(
            C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), reg.genesis,
            preset, spec)
        chain.execution_layer = el
        need(chain.pubkey_cache.device_table().device.type == "cuda" and
             C.api.get_backend_name() == "torch_cuda",
             "merge: the chain's pubkey table is not on the card or the backend "
             f"is {C.api.get_backend_name()}")
        out["chain_init_s"] = time.perf_counter() - t0
        log(f"merge: {preset.name}, bellatrix at epoch 1: a BeaconChain on the "
            f"registry's genesis with its table on the card ({out['chain_init_s']:.1f} "
            f"s), the engine "
            f"at {server.url} behind JWT; card: {card}")

        verify = C.bsv.BlockSignatureVerifier.verify
        verify_s = []

        def verify_timed(self, *args, **kwargs):
            t = time.perf_counter()
            result = verify(self, *args, **kwargs)
            verify_s.append(time.perf_counter() - t)
            return result

        def build(state, **kwargs):
            """A block on `state` (slot processing done) with the payload
            the engine builds for its proposer: (signed, post, payload ms,
            production s)."""
            proposer = PS.get_beacon_proposer_index(state, preset, spec)
            t = time.perf_counter()
            payload = el.build_payload_for_block(state, state.slot, proposer, preset, spec)
            payload_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            signed, post = produce_block(C, state, preset, spec, reg.secret_of, host,
                                         payload=payload, **kwargs)
            return signed, post, payload_ms, time.perf_counter() - t

        def import_(label, signed, want_error=None):
            """One import through chain.process_block (VERIFY_BULK): one
            backend call; the head moves to it, or stays with `want_error`."""
            chain.slot_clock.set_slot(signed.message.slot)
            head0 = chain.head_root
            C.tracing.default_tracer().reset()
            n0, verify_s[:] = len(el.notified), []

            def run():
                try:
                    return chain.process_block(signed), None
                except C.beacon_chain.BlockError as e:
                    return None, str(e)

            n_sets = len(signed.message.body.attestations) + 3
            C.bsv.BlockSignatureVerifier.verify = verify_timed
            try:
                (root, err), step_calls = calls.step(f"merge: {label}", run, [n_sets])
            finally:
                C.bsv.BlockSignatureVerifier.verify = verify
            need(err == want_error if want_error is None else
                 (err or "").startswith(want_error),
                 f"merge: {label}: error {err!r}, want {want_error!r}")
            need(chain.head_root == (head0 if want_error else root),
                 f"merge: {label}: head {'moved' if want_error else 'did not move'}")
            row = calls.rows[f"merge: {label}"]
            row.update(spans=span_ms(C, *MERGE_SPANS), first_call_s=sum(verify_s),
                       notified=len(el.notified) - n0)
            return row, step_calls

        C.tracing.configure(clock=_WallClock())
        state = PS.process_slots(PS.clone_state(reg.state), BLOCK_SLOT + 1, preset, spec)
        need(state.fork_name == "bellatrix", f"merge: slot {state.slot} is {state.fork_name}")
        blocks, epoch_ms = [], []
        process_epoch = C.per_epoch.process_epoch

        def timed_epoch(*args, **kwargs):
            t = time.perf_counter()
            process_epoch(*args, **kwargs)
            epoch_ms.append((time.perf_counter() - t) * 1e3)

        for i in range(MERGE_BLOCKS):
            signed, post, payload_ms, production_s = build(state)
            label = "merge-transition block" if i == 0 else f"block {signed.message.slot}"
            C.per_epoch.process_epoch = timed_epoch
            try:
                row, step_calls = import_(label, signed)
            finally:
                C.per_epoch.process_epoch = process_epoch
            ms = notified_since(C, el, len(el.notified) - row["notified"],
                                X.PayloadVerificationStatus.VERIFIED, f"merge: {label}")
            need(len(ms) == 1, f"merge: {label}: {len(ms)} engine round trips")
            if i == 0:  # blocks 33 and 34 are calls of the same shape
                calls.replay(f"merge: {label}", step_calls[0]["sets"])
            row.update(payload_ms=payload_ms, production_s=production_s, engine_ms=ms[0],
                       slot=int(signed.message.slot))
            out[label] = row
            blocks.append(signed)
            twin.import_([signed])
            replayed = (f", replayed {row['replayed_ms']:.1f} ms" if "replayed_ms" in row
                        else "")
            log(f"merge: {label} (slot {row['slot']}): {row['calls'][0]} sets, "
                f"{row['keys'][0]} keys, {row['pairs'][0]} pairs; first call "
                f"{row['first_call_s']:.3f} s{replayed}; span "
                f"ms {json.dumps({k: round(v, 1) for k, v in row['spans'].items()})}; "
                f"engine round trip {ms[0]:.1f} ms; host: payload {payload_ms:.1f} ms, "
                f"signing and post-state root {production_s:.3f} s; card: {card}")
            state = PS.process_slots(PS.clone_state(post), post.slot + 1, preset, spec)
        need(len(epoch_ms) == 1 and chain.head_state.fork_name == "bellatrix",
             f"merge: {len(epoch_ms)} epoch transitions, head {chain.head_state.fork_name}")
        out["process_epoch_ms"] = epoch_ms[0]
        need(not chain.optimistic_transition_blocks,
             "merge: the transition block was imported optimistically")
        head_hash = bytes(chain.head_state.latest_execution_payload_header.block_hash)
        need(head_hash in engine.blocks, "merge: the head's payload is unknown to the engine")

        # two forged blocks on the head: a tampered payload hash (the block
        # re-signed, so the card accepts its signatures) and a forged
        # attestation signature
        honest, _, _, _ = build(state)
        tampered = type(honest).from_ssz_bytes(honest.as_ssz_bytes())
        payload = tampered.message.body.execution_payload
        payload.block_hash = wrong_root(bytes(payload.block_hash))
        domain = T.get_domain(state, T.DOMAIN_BEACON_PROPOSER,
                              state.slot // preset.slots_per_epoch, preset)
        tampered.signature, = host.sign([(
            [reg.secret_of(int(tampered.message.proposer_index))],
            T.compute_signing_root(tampered.message, domain))])
        seen = server.requests_seen
        row, _ = import_("tampered payload hash", tampered,
                         want_error="invalid execution payload")
        need(server.requests_seen == seen and row["notified"] == 0 and
             row["verdicts"] == [True],
             f"merge: the tampered payload reached the engine "
             f"({server.requests_seen - seen} requests) or its signatures failed")
        out["tampered payload hash"] = row
        forged = forge_attestation(C, state, preset, spec, reg.secret_of, honest,
                                   MERGE_FORGED, host)
        row, _ = import_("forged attestation", forged,
                         want_error="bulk signature check failed")
        need(row["verdicts"] == [False], "merge: the forged block's call accepted")
        out["forged attestation"] = row

        twin.expect("merge", chain, C)
        out["requests"] = server.requests_seen
    log(f"merge: head at slot {chain.head_state.slot} (bellatrix), its payload "
        f"0x{head_hash.hex()[:16]} known to the engine, every payload VERIFIED over "
        f"HTTP+JWT ({out['requests']} engine requests); process_epoch at the transition "
        f"{out['process_epoch_ms']:.1f} ms; the tampered payload refused before the "
        f"wire, the forged attestation False on the card; the head held to the twin's "
        f"at the end of the phase; card: {card}")
    return out, twin


def sign_block(C, h, state, block, signed_cls):
    """`block` (of any fork, blinded too) signed by its proposer as the
    harness signs: the proposal domain of `state`'s epoch."""
    T = C.types
    domain = T.get_domain(state, T.DOMAIN_BEACON_PROPOSER,
                          state.slot // h.preset.slots_per_epoch, h.preset)
    return signed_cls(message=block, signature=h.producer._sign_root(
        T.compute_signing_root(block, domain), int(block.proposer_index)))


def merge_minimal(torch, B, C, host, calls, card):
    """Part (b), at MINIMAL over 64 validators, as the JAX package's tests
    drive these paths but signed: the fork crossing into bellatrix, an
    optimistic import invalidated into a reorg, a builder's bid checked
    on the card and its block unblinded and imported, and eth1 deposits
    voted in and packed by the beacon node's block production."""
    T, X, PS = C.types, C.execution_layer, C.per_slot
    preset, spe = T.MINIMAL, T.MINIMAL.slots_per_epoch
    spec = T.ChainSpec.interop(altair_fork_epoch=1, bellatrix_fork_epoch=2)
    t = T.types_for(preset)
    VERIFIED = X.PayloadVerificationStatus.VERIFIED
    out = {}
    with contextlib.ExitStack() as stack:
        engine, server, el = engine_rig(C, t, stack)
        t0 = time.perf_counter()
        h = C.harness.BeaconChainHarness(MERGE_VALIDATORS, preset, spec, sign=True,
                                         execution_layer=el)
        need(h.chain.pubkey_cache.device_table().device.type == "cuda" and
             h.strategy == C.per_block.BlockSignatureStrategy.VERIFY_BULK,
             "merge: the harness chain is not on the card or does not verify")
        out["setup_s"] = time.perf_counter() - t0

        made, produce = [], h.producer.produce_block

        def produce_recorded(*args, **kwargs):
            signed, post = produce(*args, **kwargs)
            made.append(signed)
            return signed, post

        h.producer.produce_block = produce_recorded
        try:
            _, crossing = calls.step("merge: fork crossing",
                                     lambda: h.extend_chain(MERGE_CROSSING_SLOTS))
        finally:
            h.producer.produce_block = produce
        row = calls.rows["merge: fork crossing"]
        payloads = [bytes(b.message.body.execution_payload.block_hash) for b in made
                    if hasattr(b.message.body, "execution_payload")]
        engine_ms = notified_since(C, el, 0, VERIFIED, "merge: fork crossing")
        need(len(crossing) == len(made) == MERGE_CROSSING_SLOTS and all(row["verdicts"]) and
             h.chain.head_state.fork_name == "bellatrix" and
             len(payloads) == len(made) - 2 * spe + 1 and
             set(payloads) <= set(engine.new_payload_log),
             f"merge: fork crossing: {len(crossing)} calls for {len(made)} blocks, head "
             f"{h.chain.head_state.fork_name}, {len(payloads)} payloads")
        out["fork crossing"] = dict(row, engine_ms=engine_ms)
        log(f"merge: fork crossing phase0 -> altair -> bellatrix: {len(made)} blocks, one "
            f"call each of {sorted(set(row['calls']))} sets, {row['seconds']:.3f} s; "
            f"{len(payloads)} payloads, every one in the engine's new_payload_log and "
            f"VERIFIED (round trip {min(engine_ms):.1f}-{max(engine_ms):.1f} ms); card: "
            f"{card}")

        # optimistic import, then invalidation: A and its child A2 while
        # the engine reports SYNCING, B beside A; A's payload ruled invalid
        base_root, base_slot = h.chain.head_root, int(h.chain.head_state.slot)

        def child(slot, parent_root):
            block, _ = h.producer.produce_block(slot, base_state=h.chain._states[parent_root])
            h.chain.slot_clock.set_slot(slot)
            return block, h.chain.process_block(block, strategy=h.strategy)

        engine.force_syncing = 2
        n0 = len(el.notified)
        (block_a, root_a), _ = calls.step("merge: optimistic A", lambda: child(
            base_slot + 1, base_root), [2])
        (_, root_a2), _ = calls.step("merge: optimistic A2", lambda: child(
            base_slot + 2, root_a), [2])
        need([s for _, s, _ in el.notified[n0:]] ==
             [X.PayloadVerificationStatus.OPTIMISTIC] * 2 and
             h.chain.is_optimistic(root_a) and h.chain.is_optimistic(root_a2),
             "merge: A and A2 not imported optimistically")
        n0 = len(el.notified)
        (_, root_b), _ = calls.step("merge: valid B", lambda: child(
            base_slot + 3, base_root), [2])
        notified_since(C, el, n0, VERIFIED, "merge: valid B")
        engine.mark_invalid(bytes(block_a.message.body.execution_payload.block_hash))
        new_head = h.chain.on_invalid_payload(root_a)
        status_of = h.chain.fork_choice.proto.execution_status_of
        need(new_head == root_b == h.chain.head_root and
             status_of(root_a) == status_of(root_a2) == "invalid" and
             status_of(root_b) != "invalid",
             "merge: the invalidated branch kept the head")
        log(f"merge: A and A2 imported optimistically (engine SYNCING), B VERIFIED; A's "
            f"payload marked invalid: A and A2 invalid, the head reorged onto B "
            f"(slot {base_slot + 3}); card: {card}")

        # the builder: registrations over HTTP, a bid checked on the card,
        # the signed blinded block unblinded and imported; a raised bid
        builder = X.MockBuilder(el, preset, spec, chain=h.chain)
        bserver = X.BuilderHttpServer(builder).start()
        stack.callback(bserver.stop)
        client = X.BuilderHttpClient(bserver.url, preset, timeout_s=RIG_TIMEOUT_S,
                                     trusted_pubkey=builder.pubkey.to_bytes())
        regs = [C.containers.ValidatorRegistrationV1(
            fee_recipient=b"\xfe" * 20, gas_limit=30_000_000, timestamp=1234,
            pubkey=bytes(v.pubkey)) for v in h.chain.head_state.validators]
        sigs = host.sign([([T.interop_secret_key(i).scalar],
                           C.builder.builder_signing_root(r, spec))
                          for i, r in enumerate(regs)])
        client.register_validators([
            C.containers.SignedValidatorRegistration(message=r, signature=s)
            for r, s in zip(regs, sigs)])
        need(len(builder.registrations) == MERGE_VALIDATORS,
             f"merge: the builder holds {len(builder.registrations)} registrations")
        bn = C.beacon_node.InProcessBeaconNode(h.chain)
        bn.builder = client
        slot = int(h.chain.head_state.slot) + 1
        h.chain.slot_clock.set_slot(slot)
        state = h.chain.state_for_block_production(slot)
        proposer = PS.get_beacon_proposer_index(state, preset, spec)
        randao = h.producer._randao_reveal(state, proposer)
        blinded, _ = calls.step("merge: blinded block (bid)",
                                lambda: bn.produce_blinded_block(slot, randao), [1])
        signed_blinded = sign_block(C, h, state, blinded, t.SignedBlindedBeaconBlock)
        n0 = len(el.notified)
        root, _ = calls.step("merge: unblinded import",
                             lambda: bn.publish_blinded_block(signed_blinded), [2])
        notified_since(C, el, n0, VERIFIED, "merge: unblinded import")
        need(h.chain.head_root == root and bytes(
            h.chain.head_state.latest_execution_payload_header.tree_hash_root()) ==
            bytes(blinded.body.execution_payload_header.tree_hash_root()),
             "merge: the unblinded block is not the head with the bid's header")
        slot2 = slot + 1
        state2 = h.chain.state_for_block_production(slot2)
        parent_hash = bytes(state2.latest_execution_payload_header.block_hash)
        bid = client.get_header(slot2, parent_hash, bytes(
            state2.validators[PS.get_beacon_proposer_index(state2, preset, spec)].pubkey))
        bid.message.value = int(bid.message.value) + 1

        def check_raised():
            try:
                C.builder.verify_bid(bid, spec, parent_hash, trusted_pubkey=client.trusted_pubkey)
            except X.BuilderError as e:
                return str(e)
            return None

        err, _ = calls.step("merge: raised bid", check_raised, [1])
        need(err == BAD_BID_ERROR and calls.rows["merge: raised bid"]["verdicts"] == [False],
             f"merge: the raised bid: {err!r}, want {BAD_BID_ERROR!r}")
        log(f"merge: builder at {bserver.url}: {MERGE_VALIDATORS} registrations over "
            f"HTTP, the bid verified on the card (one set), the blinded block at slot "
            f"{slot} unblinded and imported; the bid with its value raised refused "
            f"({err}); card: {card}")

        # eth1: a deposit contract chain behind JSON-RPC, the 64 genesis
        # deposits, then an honest 65th and a 66th signed over a wrong
        # root; the beacon node votes each block of the next voting period
        datas = genesis_deposit_data(C, spec, MERGE_VALIDATORS + 2, host,
                                     forged=(MERGE_VALIDATORS + 1,))
        provider = C.eth1.MockEth1Provider()
        provider.add_block(100, datas[:MERGE_VALIDATORS])
        provider.add_block(101, datas[MERGE_VALIDATORS:])
        for i in range(6):  # bury them past the follow distance
            provider.add_block(102 + i)
        eserver = C.eth1.Eth1RpcServer(provider).start()
        stack.callback(eserver.stop)
        svc = C.eth1.Eth1Service(C.eth1.JsonRpcEth1Provider(
            eserver.url, retries=1, timeout_s=RIG_TIMEOUT_S))
        svc.update()
        need(len(svc.block_cache) == 8 and len(svc.deposit_tree.leaves) == len(datas),
             f"merge: eth1 service cached {len(svc.block_cache)} blocks")
        bn.eth1_service = svc
        period = preset.slots_per_eth1_voting_period
        first = -(-slot2 // period) * period  # the next voting period's first slot
        majority = period // 2 + 1

        def produce_and_import(slot):
            h.chain.slot_clock.set_slot(slot)
            state = h.chain.state_for_block_production(slot)
            block = bn.produce_block(slot, h.producer._randao_reveal(
                state, PS.get_beacon_proposer_index(state, preset, spec)))
            _, signed_cls, _ = C.containers.block_classes_for(t, state.fork_name)
            signed = sign_block(C, h, state, block, signed_cls)
            return block, bn.publish_block(signed)

        n0 = len(el.notified)
        votes, vote_calls = calls.step("merge: eth1 votes", lambda: [
            produce_and_import(s) for s in range(first, first + majority - 1)])
        need(len(vote_calls) == majority - 1 and not any(b.body.deposits for b, _ in votes),
             f"merge: {len(vote_calls)} calls for {majority - 1} voting blocks")
        (block, root), dep_calls = calls.step(
            "merge: deposit block", lambda: produce_and_import(first + majority - 1))
        notified_since(C, el, n0, VERIFIED, "merge: eth1 votes")
        state = h.chain.head_state
        sizes = calls.rows["merge: deposit block"]["calls"]
        need(h.chain.head_root == root and len(block.body.deposits) == 2 and
             len(state.validators) == MERGE_VALIDATORS + 1 and
             bytes(state.validators[MERGE_VALIDATORS].pubkey) == bytes(
                 datas[MERGE_VALIDATORS].pubkey) and
             int(state.eth1_deposit_index) == MERGE_VALIDATORS + 2,
             f"merge: deposit block: {len(block.body.deposits)} deposits, "
             f"{len(state.validators)} validators, deposit index {state.eth1_deposit_index}")
        # production's state root checks each deposit once, import again
        need(calls.rows["merge: deposit block"]["verdicts"] == [True, False, True, True, False]
             and sizes == [1, 1, 2, 1, 1], f"merge: deposit block calls {sizes}, verdicts "
             f"{calls.rows['merge: deposit block']['verdicts']}")
        cache = h.chain.pubkey_cache
        table = cache.device_table()
        torch.cuda.synchronize()
        new_row = table[MERGE_VALIDATORS].cpu()
        need(table.device.type == "cuda" and len(cache) == MERGE_VALIDATORS + 1 and
             torch.equal(new_row, torch.from_numpy(B._pk_limbs(cache.get(MERGE_VALIDATORS)))),
             "merge: the new validator's key is not in the card's table as packed")
        out.update(eth1_votes=calls.rows["merge: eth1 votes"],
                   deposit_block=calls.rows["merge: deposit block"],
                   included_at=int(block.slot), validators=len(state.validators),
                   requests=server.requests_seen)
    log(f"merge: eth1 at {eserver.url}: {majority - 1} blocks voted (one call each, "
        f"{calls.rows['merge: eth1 votes']['seconds']:.3f} s), the {majority}th (slot "
        f"{out['included_at']}) packed the 2 owed deposits: the honest one's key is "
        f"validator {MERGE_VALIDATORS}, its limbs in the card's table as packed; the "
        f"forged one skipped ({out['validators']} validators); card: {card}")
    return out


def phase_merge(torch, K, TP, B, C, reg, launches, card, twin_worker):
    """Blocks past the merge on the card: part (a) at MAINNET, part (b)
    at MINIMAL; every call's launches held to expected_launches and its
    verdict to the cpu oracle's, part (a)'s head to its twin's (which
    imports its blocks in `twin_worker` meanwhile)."""
    t_phase = time.perf_counter()
    calls = Calls(torch, K, TP, B, C, reg.host, launches, card)
    mainnet, twin = merge_mainnet(torch, B, C, reg, calls, card, twin_worker)
    out = dict(mainnet=mainnet)
    t_minimal = time.perf_counter()
    out["minimal"] = merge_minimal(torch, B, C, reg.host, calls, card)
    out["oracle_wait_s"] = calls.check_oracle("merge")
    out["mainnet"]["twin_wait_s"] = twin.check()
    out["mainnet"]["twin_s"] = twin.seconds
    twin.close()
    log(f"merge: MAINNET: the head equal to the twin's ({twin.seconds:.1f} s in its "
        f"worker, waited {out['mainnet']['twin_wait_s']:.1f} s); card: {card}")
    out["seconds"] = time.perf_counter() - t_phase
    out["mainnet"]["seconds"] = t_minimal - t_phase
    out["minimal"]["seconds"] = out["seconds"] - out["mainnet"]["seconds"]
    log(f"merge: every verdict equal to the cpu oracle's (waited "
        f"{out['oracle_wait_s']:.1f} s); phase wall {out['seconds']:.1f} s (MAINNET part "
        f"{out['mainnet']['seconds']:.1f} s, MINIMAL part {out['minimal']['seconds']:.1f} "
        f"s, harness set-up {out['minimal']['setup_s']:.1f} s); card: {card}")
    return out


# --- the network phase: the gossip network, range sync, the slasher, the wire


NETWORK_ATTESTATIONS = 64  # b's processor's gossip batch: the warmed bucket (64, 4, 4)
NETWORK_PEERS = ("a", "b", "c")  # the MAINNET part's nodes
WIRE_BLOCKS = 8  # the wire part's chain when the finality phase did not run
WIRE_WAIT_S = 30.0  # the deadline for a gossip frame to cross the sockets and import
WIRE_IDENTITY = 0x5EC0  # the wire nodes' identity secrets: this + 0, + 1
NETWORK_SPANS = ("block_gossip_verify", "block_signature_verify")


@contextlib.contextmanager
def timed_attrs(sink, *targets, key=None):
    """Each (object, attribute) replaced for the block by a wrapper that
    appends (label, seconds) of every call to `sink` (threads too: a
    list append is atomic); the label is "owner.attribute" (the module's,
    class's or instance type's last name), or key(*args) of the call.
    Restored after."""
    import functools

    saved = []

    def wrap(label, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.append((label if key is None else key(*args),
                             time.perf_counter() - t))
        return timed

    for obj, name in targets:
        owner = getattr(obj, "__name__", type(obj).__name__).rsplit(".", 1)[-1]
        # an instance's method lives on its class: restored by deleting
        # the wrapper, not by pinning the bound method on the instance
        own = name in vars(obj)
        saved.append((obj, name, getattr(obj, name) if own else None))
        setattr(obj, name, wrap(f"{owner}.{name}", getattr(obj, name)))
    try:
        yield sink
    finally:
        for obj, name, fn in reversed(saved):
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)


def timed_ms(sink) -> dict:
    """{label: [calls, ms]} of a `timed_attrs` sink."""
    out = {}
    for name, secs in sink:
        row = out.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += secs * 1e3
    return out


def network_chain(C, genesis, preset, spec):
    """A node's BeaconChain from `genesis` over its own MemoryStore, its
    pubkey table on the card (the port's default device)."""
    return C.beacon_chain.BeaconChain(
        C.hot_cold.HotColdDB(C.kv.MemoryStore(), preset, spec), genesis, preset, spec)


def chain_on_card(C, label, chain):
    """The chain's pubkey table on the card and the backend torch_cuda:
    else the phase would not verify on the card."""
    dev = chain.pubkey_cache.device_table().device
    need(dev.type == "cuda", f"{label}: the chain's pubkey table is on {dev}")
    need(C.api.get_backend_name() == "torch_cuda",
         f"{label}: the backend is {C.api.get_backend_name()}, not torch_cuda")


def nodes_on_card(C, label, nodes):
    """`chain_on_card` for every node's chain."""
    for n in nodes:
        chain_on_card(C, f"{label}: {n.peer_id}", n.chain)


def network_twin(C, genesis, preset, spec, blocks, nodes, label) -> float:
    """A BeaconChain that imports `blocks` with NO_VERIFICATION; every
    node's head, head state root and checkpoints must equal its. Returns
    the twin's seconds."""
    t0 = time.perf_counter()
    twin = network_chain(C, genesis, preset, spec)
    NOV = C.per_block.BlockSignatureStrategy.NO_VERIFICATION
    for b in blocks:
        twin.slot_clock.set_slot(b.message.slot)
        twin.process_block(b, strategy=NOV)
    view = chain_view(C, twin)
    differ = [n.peer_id for n in nodes if chain_view(C, n.chain) != view]
    need(not differ, f"{label}: the heads or checkpoints of {differ} differ from the "
         "NO_VERIFICATION twin's")
    return time.perf_counter() - t0


def drain(node, label):
    """Run the node's processor until its queues are empty; a handler
    that raised fails the phase."""
    errors = node.processor.handler_errors
    node.processor.run_until_idle()
    need(node.processor.handler_errors == errors,
         f"{label}: {node.peer_id}'s processor handler raised: "
         f"{node.processor.last_error}")


def replay_step(calls, label, step_calls):
    """Each call of the step `label` once more through `Calls.replay` (its
    bucket's graphs captured by the step), at the verdict the step had:
    the replayed ms of each, kept in the step's row."""
    ms = [calls.replay(label, c["sets"], bool(c["out"])) for c in step_calls]
    calls.rows[label]["replayed_ms"] = ms
    return ms


def double_vote(C, state, preset, spec, secret_of, committee, honest, host):
    """The double vote of `committee`'s first member v: its honest vote
    `honest` (signed by an honest ValidatorStore, which then refuses the
    conflicting vote with NotSafe), and a vote for the genesis block at
    the same slot and target signed by a ByzantineValidatorStore holding
    the same key with a slashing database of its own (the same key run
    in two clients); the byzantine store's refusal of the honest vote
    overridden and audited. The conflicting vote travels as an aggregate
    of v's bit alone, by an aggregator of the committee whose key the
    byzantine store also holds. Returns (SignedAggregateAndProof, v, the
    NotSafe text, the byzantine store)."""
    T, VC = C.types, C.vc
    t = T.types_for(preset)
    v = committee[0]
    slot = int(honest.data.slot)
    sel_root = T.SigningData(
        object_root=C.ssz.uint64.hash_tree_root(slot),
        domain=T.get_domain(state, T.DOMAIN_SELECTION_PROOF, slot // preset.slots_per_epoch,
                            preset)).tree_hash_root()
    found = None
    others = [m for m in committee if secret_of(m) != secret_of(v)]
    for c0 in range(0, len(others), SELECTION_CHUNK):
        chunk = others[c0:c0 + SELECTION_CHUNK]
        proofs = host.sign([([secret_of(m)], sel_root) for m in chunk])
        found = next(((m, p) for m, p in zip(chunk, proofs)
                      if C.att.is_aggregator(len(committee), p, spec)), None)
        if found:
            break
    need(found is not None, "network: no aggregator in the double vote's committee")
    x, proof = found
    key_v = VC.LocalKeystore(C.api.SecretKey(secret_of(v)))
    key_x = VC.LocalKeystore(C.api.SecretKey(secret_of(x)))
    pk_v, pk_x = key_v.pubkey.to_bytes(), key_x.pubkey.to_bytes()
    honest_store = VC.ValidatorStore(preset, spec)
    honest_store.add_validator(key_v, validator_index=v)
    byz = VC.ByzantineValidatorStore(preset, spec)
    byz.add_validator(key_v, validator_index=v)
    byz.add_validator(key_x, validator_index=x)
    need(honest_store.sign_attestation(pk_v, honest.data, state).to_bytes()
         == bytes(honest.signature), "network: the honest store's vote differs")
    data = T.AttestationData(
        slot=honest.data.slot, index=honest.data.index,
        beacon_block_root=C.helpers.get_block_root_at_slot(state, 0, preset),
        source=honest.data.source, target=honest.data.target)
    signature = byz.sign_attestation(pk_v, data, state).to_bytes()
    refused = None
    try:
        honest_store.sign_attestation(pk_v, data, state)
    except VC.NotSafe as e:
        refused = str(e)
    need(refused is not None, "network: the honest store signed the double vote")
    byz.sign_attestation(pk_v, honest.data, state)
    need([k for k, _, _ in byz.overrides] == ["attestation"],
         f"network: the byzantine store's overrides {byz.overrides}")
    need(byz.sign_selection_proof(pk_x, slot, state).to_bytes() == proof,
         "network: the byzantine store's selection proof differs")
    msg = t.AggregateAndProof(
        aggregator_index=x, selection_proof=proof,
        aggregate=t.Attestation(aggregation_bits=honest.aggregation_bits, data=data,
                                signature=signature))
    signed = t.SignedAggregateAndProof(
        message=msg, signature=byz.sign_aggregate_and_proof(pk_x, msg, state).to_bytes())
    return signed, v, refused, byz


def network_mainnet(C, reg, calls, card):
    """Part (a): MAINNET over the registry's genesis and the in-process
    MessageBus. Nodes a and b (their tables on the card); a publishes
    the block at BLOCK_SLOT and b imports it by gossip; 64 attestations
    in one batch on b; a forged one penalised; a double vote and a double
    proposal found by b's slasher and checked by a; a segment relayed by
    a, imported by b by gossip and range-synced by c in one call; every
    head the registry twin's at that block."""
    PS, N = C.per_slot, C.network
    preset, spec, host = reg.preset, reg.spec, reg.host
    out, routing = {}, []
    t0 = time.perf_counter()
    bus = N.MessageBus()
    a, b = (N.NetworkNode(p, network_chain(C, reg.genesis, preset, spec), bus)
            for p in NETWORK_PEERS[:2])
    b.attach_slasher(C.slasher.Slasher.open(C.kv.MemoryStore(), preset, spec))
    nodes_on_card(C, "network", (a, b))
    out["nodes_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    b31, post31 = reg.block or produce_block(C, reg.state, preset, spec, reg.secret_of, host)
    # the segment after block 31: the chain phase's blocks when it ran (the
    # same blocks: produce_segment is deterministic), else made here
    by_slot = {blk.message.slot: blk for blk in reg.twin.imported}
    slots = range(BLOCK_SLOT + 1, BLOCK_SLOT + 1 + CHAIN_SEGMENT)
    if all(s in by_slot for s in slots):
        segment = [by_slot[s] for s in slots]
    else:
        segment, _ = produce_segment(C, post31, preset, spec, reg.secret_of, host,
                                     CHAIN_SEGMENT)
    parents = [b31.message.tree_hash_root()] + [
        blk.message.tree_hash_root() for blk in segment[:-1]]
    need([bytes(blk.message.parent_root) for blk in segment] == parents,
         "network: the segment does not extend block 31")
    s32 = PS.process_slots(PS.clone_state(post31), BLOCK_SLOT + 1, preset, spec)
    unagg = gossip_unaggregated(C, s32, preset, spec, reg.secret_of, BLOCK_SLOT,
                                NETWORK_ATTESTATIONS + 1, host)
    honest = unagg[:NETWORK_ATTESTATIONS]
    forged, = forge_gossip(C, s32, preset, spec, reg.secret_of, unagg[-1:], (0,), host)
    committee = C.context.ConsensusContext(preset, spec).committee_cache(
        s32, 0).get_beacon_committee(BLOCK_SLOT, 0)
    conflicting, voter, refused, byz = double_vote(
        C, s32, preset, spec, reg.secret_of, committee, honest[0], host)
    double, _ = produce_block(C, reg.state, preset, spec, reg.secret_of, host, attest=False)
    out["build_s"] = time.perf_counter() - t0
    log(f"network: nodes a, b over a MessageBus, their tables on the card, b's slasher "
        f"attached ({out['nodes_s']:.1f} s); built block {BLOCK_SLOT}, the segment "
        f"{segment[0].message.slot}-{segment[-1].message.slot}, "
        f"{NETWORK_ATTESTATIONS} + 1 forged attestations, validator {voter}'s double vote "
        f"(the honest store refused it: {refused!r}; the byzantine store overrode "
        f"{len(byz.overrides)}) and a double proposal in {out['build_s']:.1f} s; card: {card}")

    def at(slot, *nodes):
        for n in nodes:
            n.chain.slot_clock.set_slot(slot)

    def n_sets(*blocks):
        return sum(len(blk.message.body.attestations) + 3 for blk in blocks)

    def step(label, fn, want):
        C.tracing.default_tracer().reset()
        result, step_calls = calls.step(f"network: {label}", fn, want)
        out[label] = calls.rows[f"network: {label}"]
        return result, step_calls

    root31 = b31.message.tree_hash_root()
    at(BLOCK_SLOT, a, b)
    # a publish's seconds by gossip kind: delivery into the receivers'
    # queues, and for the slashing kinds the receiver's check on the card
    # too (op gossip is handled as it arrives)
    slasher_batches = []
    with timed_attrs(routing, (bus, "publish"),
                     key=lambda source, topic, payload: topic.split("/")[3].rstrip(
                         "_0123456789")), \
            timed_attrs(slasher_batches, (b.slasher_service.slasher, "process_queued")):
        step("a publishes the block", lambda: a.publish_block(b31), [n_sets(b31)])
        _, gossip_calls = step("b imports the block by gossip",
                               lambda: drain(b, "network"), [1, n_sets(b31) - 1])
        need(a.chain.head_root == b.chain.head_root == root31,
             "network: the block is not both nodes' head")
        row = out["b imports the block by gossip"]
        row["first_call_ms"] = list(span_ms(C, *NETWORK_SPANS).values())
        log(f"network: the block by gossip: span ms (the call and its host work) "
            f"{json.dumps(dict(zip(NETWORK_SPANS, map(round, row['first_call_ms']))))}; "
            f"card: {card}")
        replay_step(calls, "network: b imports the block by gossip", gossip_calls)

        def attestations():
            for att in honest:
                a.publish_attestation(att)
            drain(b, "network")

        _, att_calls = step("b verifies the attestation batch", attestations,
                            [NETWORK_ATTESTATIONS])
        pooled = {bytes(x.data.tree_hash_root()): x.data for x in honest}
        n_pooled = sum(sum((b.naive_pool.get(d) or {"bits": ()})["bits"])
                       for d in pooled.values())
        need(n_pooled == NETWORK_ATTESTATIONS,
             f"network: {n_pooled} of {NETWORK_ATTESTATIONS} attestations in b's naive pool")
        replay_step(calls, "network: b verifies the attestation batch", att_calls)

        score0 = b.peer_scores.get("a", 0)

        def forged_attestation():
            a.publish_attestation(forged)
            drain(b, "network")

        step("b rejects a forged attestation", forged_attestation, [1])
        penalty = b.peer_scores.get("a", 0) - score0
        need(penalty == C.net_node.GOSSIP_PENALTY and
             out["b rejects a forged attestation"]["verdicts"] == [False],
             f"network: the forged attestation cost a {penalty}")

        def conflicting_aggregate():
            bus.publish(a.peer_id, a._topic_aggregate, conflicting)
            drain(b, "network")

        step("b verifies the conflicting aggregate", conflicting_aggregate, [3])
        need(out["b verifies the conflicting aggregate"]["verdicts"] == [True],
             "network: the conflicting aggregate was rejected")
        _, found_calls = step("b's slasher finds the double vote, a checks it",
                              b.on_slot, [2])
        svc = b.slasher_service
        need(svc.attester_slashings_found == 1 and len(a.op_pool._attester_slashings) == 1
             and out["b's slasher finds the double vote, a checks it"]["verdicts"]
             == [True], f"network: {svc.attester_slashings_found} attester slashings "
             f"found, {len(a.op_pool._attester_slashings)} in a's pool")
        found = a.op_pool._attester_slashings[0]
        need(voter in set(found.attestation_1.attesting_indices)
             & set(found.attestation_2.attesting_indices),
             "network: the attester slashing does not name the double voter")
        replay_step(calls, "network: b's slasher finds the double vote, a checks it",
                    found_calls)

        equivocations0 = C.metrics.BLOCK_EQUIVOCATIONS.value

        def double_proposal():
            bus.publish(a.peer_id, a._topic_block, double)
            drain(b, "network")

        step("b sees the double proposal", double_proposal, [1, 2])
        need(C.metrics.BLOCK_EQUIVOCATIONS.value - equivocations0 == 1
             and b.chain.head_root == root31,
             "network: the double proposal was not counted once as an equivocation, "
             "or it moved b's head")
        _, found_calls = step("b's slasher finds the double proposal, a checks it",
                              b.on_slot, [2])
        need(svc.proposer_slashings_found == 1 and len(a.op_pool._proposer_slashings) == 1,
             f"network: {svc.proposer_slashings_found} proposer slashings found, "
             f"{len(a.op_pool._proposer_slashings)} in a's pool")
        replay_step(calls, "network: b's slasher finds the double proposal, a checks it",
                    found_calls)

        c = N.NetworkNode(NETWORK_PEERS[2], network_chain(C, reg.genesis, preset, spec), bus)
        nodes_on_card(C, "network", (c,))
        got, _ = step("c range-syncs the block from b", lambda: c.sync_with(b.peer_id),
                      [n_sets(b31)])
        need(got == 1 and c.chain.head_root == root31,
             f"network: c synced {got} blocks, its head elsewhere")
        bus.disconnect(c.peer_id)

        def gossip_segment():
            # a relays the segment (its own import is shown once, at block 31)
            for blk in segment:
                at(blk.message.slot, b)
                bus.publish(a.peer_id, a._topic_block, blk)
                drain(b, "network")
            return b.chain.head_root

        want = [k for blk in segment for k in (1, n_sets(blk) - 1)]
        head, _ = step("the segment by gossip", gossip_segment, want)
        need(head == segment[-1].message.tree_hash_root(),
             "network: b does not hold the segment's head")
        c = N.NetworkNode(c.peer_id, c.chain, bus)  # c rejoins the bus
        got, sync_calls = step("c range-syncs the segment from b",
                               lambda: c.sync_with(b.peer_id), [n_sets(*segment)])
        need(got == CHAIN_SEGMENT and c.chain.head_root == head,
             f"network: c synced {got} of {CHAIN_SEGMENT} blocks")
        replay_step(calls, "network: c range-syncs the segment from b", sync_calls)
    out["routing_ms"] = timed_ms(routing)
    out["slasher_ms"] = [round(secs * 1e3, 1) for _, secs in slasher_batches]
    # every node's view is held to the registry twin's at its head: the
    # twin imported these blocks in the chain phase, else it imports them now
    need(a.chain.head_root == root31 and b.chain.head_root == head,
         "network: a's head is not block 31 or b's not the segment's last")
    reg.twin.import_([b31] + segment)
    for n in (a, b, c):
        reg.twin.expect(f"network: {n.peer_id}", n.chain, C)
    log(f"network: MAINNET: the head of a at slot {BLOCK_SLOT}, of b and c at slot "
        f"{segment[-1].message.slot}, each held to the twin's there at the end of the "
        f"run; b's score of a {b.peer_scores.get('a')}; "
        f"publishes by kind [n, ms] "
        f"{json.dumps({k: [n, round(ms, 1)] for k, (n, ms) in out['routing_ms'].items()})}"
        f"; b's slasher batches {out['slasher_ms']} ms; card: {card}")
    return out


def _enr_record(scalar, host, tcp_port):
    """Worker: the bytes of a node record signed by secret `scalar`, made
    in another process than the one that checks it (as a peer's record
    arrives)."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.network import discovery

    return discovery.make_enr(api.SecretKey(scalar), host, 0, tcp_port).to_bytes()


def wire_chain(C, shared):
    """The MINIMAL chain the wire part carries: the finality phase's
    genesis and blocks when it ran in this process, else WIRE_BLOCKS
    blocks the port's StateHarness (64 validators, signing) makes. At
    most SyncManager's batch of slots, so one range request holds them."""
    T = C.types
    spec = T.ChainSpec.minimal()
    if "finality" in shared:
        genesis, blocks = shared["finality"]
    else:
        h = C.harness.StateHarness(FINALITY_VALIDATORS, T.MINIMAL, spec, sign=True)
        genesis = C.per_slot.clone_state(h.state)
        h.extend_chain(WIRE_BLOCKS,
                       strategy=C.per_block.BlockSignatureStrategy.NO_VERIFICATION)
        blocks = h.blocks
    return genesis, spec, [b for b in blocks if b.message.slot <= C.net_sync.BATCH_SIZE]


def network_wire(B, C, host, shared, calls, card):
    """Part (b): MINIMAL over WireBus on 127.0.0.1: a Bootnode and two
    nodes on secure, authenticated channels. w0 holds the chain; w1
    joins late and range-syncs all but the last block over the wire in
    one call, then imports the last as a gossip frame from w0 (ssz_snappy
    over the sockets); both heads the twin's. The control plane (node
    records, the handshake transcripts, the bootnode's registration
    proofs) runs on the cpu oracle; an unreachable peer fails the part."""
    import functools
    import random

    T, N, W, S, D = C.types, C.network, C.wire, C.secure, C.discovery
    preset = T.MINIMAL
    out, codec, plane = {}, [], []
    t_part = time.perf_counter()
    genesis, spec, blocks = wire_chain(C, shared)
    need(len(blocks) >= 2, f"network: wire: {len(blocks)} blocks")
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_attrs(
            plane, (D.Enr, "verify"), (S, "_verify_transcript"),
            (W, "_verify_register_proof"), (S, "_sign_transcript"),
            (W, "_sign_register_proof")))
        # the control plane makes no backend call: its checks are pinned to
        # the cpu oracle (the steps below hold their handshakes' calls too)
        control_stack = stack.enter_context(contextlib.ExitStack())
        control = control_stack.enter_context(backend_calls(B, C.metrics))
        records = host.map(functools.partial(_enr_record, host="127.0.0.1", tcp_port=9000),
                           [WIRE_IDENTITY, WIRE_IDENTITY + 1])
        verdicts = [D.Enr.from_bytes(r).verify() for r in records]
        tampered = bytearray(records[0])
        tampered[8 + 48 + 4] ^= 1  # the udp port, under the signature
        verdicts.append(D.Enr.from_bytes(bytes(tampered)).verify())
        need(verdicts == [True, True, False], f"network: wire: ENR verdicts {verdicts}")

        boot = W.Bootnode().start()
        stack.callback(boot.stop)
        nodes = []
        for i in range(2):
            bus = W.WireBus(preset, secure=True, authenticate=True,
                            identity_sk=C.api.SecretKey(WIRE_IDENTITY + i),
                            rng=random.Random(i))
            node = N.NetworkNode(f"w{i}", network_chain(C, C.per_slot.clone_state(genesis),
                                                        preset, spec), bus)
            bus.listen(node.peer_id)
            stack.callback(bus.stop)
            nodes.append(node)
        w0, w1 = nodes
        nodes_on_card(C, "network: wire", nodes)
        stack.enter_context(timed_attrs(
            codec, (w0.bus.codec, "encode_gossip"), (w0.bus.codec, "encode_response"),
            (w1.bus.codec, "decode_gossip"), (w1.bus.codec, "decode_response")))
        NOV = C.per_block.BlockSignatureStrategy.NO_VERIFICATION
        for blk in blocks[:-1]:  # w0 holds the chain (verified on the card where it was made)
            w0.chain.slot_clock.set_slot(blk.message.slot)
            w0.chain.process_block(blk, strategy=NOV)
        t0 = time.perf_counter()
        dialed = [w0.bus.bootstrap(boot), w1.bus.bootstrap(boot)]
        listed = W.Bootnode.rpc(boot.host, boot.port, {"op": "list"})["peers"]
        need(dialed == [0, 1] and sorted(p["peer_id"] for p in listed if p["identity_pk"])
             == ["w0", "w1"], f"network: wire: dialed {dialed}, the bootnode lists "
             f"{[(p['peer_id'], bool(p['identity_pk'])) for p in listed]}")
        out["bootstrap_s"] = time.perf_counter() - t0
        control_stack.close()
        need(not control, f"network: wire: the control plane made {len(control)} "
             "backend calls")

        got, sync_calls = calls.step(
            "network: wire: w1 range-syncs over the sockets",
            lambda: w1.sync_with(w0.peer_id), [sum(
                len(blk.message.body.attestations) + 2 for blk in blocks[:-1])])
        need(got == len(blocks) - 1 and w1.chain.head_root == w0.chain.head_root,
             f"network: wire: w1 synced {got} of {len(blocks) - 1} blocks")
        out["range_sync"] = calls.rows["network: wire: w1 range-syncs over the sockets"]
        replay_step(calls, "network: wire: w1 range-syncs over the sockets", sync_calls)

        last = blocks[-1]
        root = last.message.tree_hash_root()

        def gossip():
            for n in nodes:
                n.chain.slot_clock.set_slot(last.message.slot)
            w0.publish_block(last)
            deadline = time.perf_counter() + WIRE_WAIT_S
            while w1.chain.head_root != root and time.perf_counter() < deadline:
                drain(w1, "network: wire")
                time.sleep(0.005)
            need(w1.chain.head_root == root,
                 f"network: wire: the gossip block did not import on w1 within "
                 f"{WIRE_WAIT_S} s")

        k = len(last.message.body.attestations) + 2
        _, gossip_calls = calls.step("network: wire: a gossip block over the sockets",
                                     gossip, [k, 1, k - 1])
        out["gossip"] = calls.rows["network: wire: a gossip block over the sockets"]
        replay_step(calls, "network: wire: a gossip block over the sockets",
                    gossip_calls[1:])
        out["frames_sent"] = w0.bus.stats["gossip_frames_sent"]
    out["codec_ms"] = timed_ms(codec)
    out["control_plane_ms"] = timed_ms(plane)
    out["twin_s"] = network_twin(C, genesis, preset, spec, blocks, (w0, w1),
                                 "network: wire")
    out["blocks"] = len(blocks)
    out["seconds"] = time.perf_counter() - t_part
    log(f"network: wire: {len(blocks)} MINIMAL blocks, bootstrap of w0 and w1 over "
        f"secure authenticated channels {out['bootstrap_s']:.2f} s; the cpu-pinned "
        f"control plane [n, ms] "
        f"{json.dumps({k: [n, round(ms, 1)] for k, (n, ms) in out['control_plane_ms'].items()})}"
        f"; ssz_snappy host [n, ms] "
        f"{json.dumps({k: [n, round(ms, 2)] for k, (n, ms) in out['codec_ms'].items()})}; "
        f"both heads the twin's ({out['twin_s']:.1f} s); every server and socket closed; "
        f"part wall {out['seconds']:.1f} s; card: {card}")
    return out


def phase_network(torch, K, TP, B, C, reg, shared, launches, card):
    """The gossip network on the card: part (a) at MAINNET over the
    in-process MessageBus, part (b) at MINIMAL over WireBus sockets;
    every call's launches held to expected_launches and its verdict to
    the cpu oracle's."""
    t_phase = time.perf_counter()
    C.tracing.configure(clock=_WallClock())
    calls = Calls(torch, K, TP, B, C, reg.host, launches, card)
    out = dict(mainnet=network_mainnet(C, reg, calls, card))
    t_wire = time.perf_counter()
    out["wire"] = network_wire(B, C, reg.host, shared, calls, card)
    out["oracle_wait_s"] = calls.check_oracle("network")
    out["seconds"] = time.perf_counter() - t_phase
    out["mainnet"]["seconds"] = t_wire - t_phase
    log(f"network: every verdict equal to the cpu oracle's (waited "
        f"{out['oracle_wait_s']:.1f} s); phase wall {out['seconds']:.1f} s (MAINNET part "
        f"{out['mainnet']['seconds']:.1f} s, wire part {out['wire']['seconds']:.1f} s); "
        f"card: {card}")
    return out


# --- the http phase: the beacon API over HTTP, keys, the validator client


HTTP_TIMEOUT_S = 60.0  # every HTTP client's socket timeout (a 16,384-row body included)
HTTP_EVENT_WAIT_S = 30.0  # the deadline for an SSE stream's events
HTTP_SYNC_MESSAGES = 4  # honest sync-committee messages posted over HTTP, one call each
HTTP_KEYSTORES = 4  # interop keys in EIP-2335 keystores: scrypt, the last one pbkdf2
HTTP_KEY_BASE = 2000  # their interop indices from here; the remote signer's follows
HTTP_PRESSURE_S = 10.0  # the forced queue-wait p95: 20x the admission threshold
HTTP_GRAFFITI = b"lighthouse over http"
VC_VALIDATORS = 16  # part (c)'s harness chain: distinct interop keys, MINIMAL
VC_SYNC_MESSAGES = 2  # the VC's sync-committee messages posted over HTTP
# the routes part (a) reads cold, cached and revalidated (304)
HTTP_GET_ROUTES = ("/eth/v1/beacon/states/head/validators",
                   "/eth/v1/beacon/states/head/committees",
                   "/eth/v1/beacon/headers/head", "/eth/v1/beacon/genesis")
SERVING_FAMILIES = ("SERVING_CACHE_HITS", "SERVING_CACHE_MISSES",
                    "SERVING_CACHE_INVALIDATIONS", "SERVING_CACHE_ENTRIES",
                    "SERVING_NOT_MODIFIED", "SERVING_SHED_READ_ONLY", "SERVING_SHED_DEBUG",
                    "SERVING_SSE_SUBSCRIBERS", "SERVING_SSE_DROPPED", "SERVING_SSE_REJECTED",
                    "SERVING_EVENT_RING_DROPPED", "SERVING_COALESCED")


def http_request(url, method="GET", body=None, headers=None):
    """(status, headers, body bytes, ms) of one request; an HTTP error
    status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            status, got, payload = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, got, payload = e.code, dict(e.headers), e.read()
    return status, got, payload, (time.perf_counter() - t) * 1e3


class SseSubscriber:
    """A thread that reads `/eth/v1/events?topics=...&limit=n` and keeps
    each event as (kind, payload, perf_counter at its data line); it is
    attached to the broadcaster when the constructor returns. The server
    closes the stream after `limit` events, or when it stops."""

    def __init__(self, base, topics, limit, broadcaster):
        import threading

        self.events, self.error = [], None
        url = f"{base}/eth/v1/events?topics={topics}&limit={limit}"
        n0 = broadcaster.subscriber_count
        self._thread = threading.Thread(target=self._read, args=(url,), daemon=True)
        self._thread.start()
        deadline = time.perf_counter() + HTTP_EVENT_WAIT_S
        while (broadcaster.subscriber_count == n0 and self._thread.is_alive()
               and time.perf_counter() < deadline):
            time.sleep(0.002)
        need(broadcaster.subscriber_count > n0,
             f"http: the SSE subscriber did not attach ({self.error!r})")

    def _read(self, url):
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=HTTP_EVENT_WAIT_S) as r:
                kind = None
                for raw in r:
                    line = raw.decode().rstrip("\n")
                    if line.startswith("event: "):
                        kind = line[len("event: "):]
                    elif line.startswith("data: "):
                        self.events.append((kind, json.loads(line[len("data: "):]),
                                            time.perf_counter()))
        except Exception as e:  # noqa: BLE001 -- reported by join
            self.error = e

    def join(self):
        self._thread.join(HTTP_EVENT_WAIT_S)
        need(not self._thread.is_alive() and self.error is None,
             f"http: the SSE stream did not end cleanly ({self.error!r})")
        return self.events


def closed_port() -> int:
    """A port of 127.0.0.1 that nothing listens on (bound, then closed)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_mainnet(C, reg, calls, card):
    """Part (a): the node's side at MAINNET. A BeaconChain on the
    registry's genesis (its table on the card) behind BeaconApiServer and
    a ServingTier whose admission reads a health source the part sets; a
    BeaconNodeHttpClient posts block 31 (one call of its sets) while an
    SSE subscriber waits for its block and head events; the big GETs
    cold, cached and revalidated; the duties of every validator; sync
    messages (one call each) and a forged one; a read-only GET shed under
    forced pressure while a duty POST passes; /lighthouse/health and
    /metrics."""
    H, S, M = C.http_api, C.serving, C.metrics
    preset, spec, host = reg.preset, reg.spec, reg.host
    out = {}
    t0 = time.perf_counter()
    b31, post31 = reg.block or produce_block(C, reg.state, preset, spec, reg.secret_of, host)
    root31 = b31.message.tree_hash_root()
    positions = list(range(HTTP_SYNC_MESSAGES + 1))
    msgs = sync_messages(C, post31, preset, spec, reg.secret_of, BLOCK_SLOT, root31, host,
                         forge=(positions[-1],), positions=positions)
    chain = network_chain(C, reg.genesis, preset, spec)
    chain_on_card(C, "http", chain)
    pressure = {}
    tier = S.ServingTier(chain, S.ServingConfig(), health_source=lambda: dict(pressure))
    server = H.BeaconApiServer(H.BeaconApi(C.vc.InProcessBeaconNode(chain)), serving=tier)
    server.start()
    out["setup_s"] = time.perf_counter() - t0
    try:
        base = f"http://127.0.0.1:{server.port}"
        client = H.BeaconNodeHttpClient(base, preset, timeout=HTTP_TIMEOUT_S)
        chain.slot_clock.set_slot(BLOCK_SLOT)
        emitted = {}
        # first of the sinks: the time an event leaves the import
        chain.event_sinks.insert(
            0, lambda kind, payload: emitted.setdefault(kind, time.perf_counter()))
        sub = SseSubscriber(base, "block,head", 2, tier.broadcaster)
        n_sets = len(b31.message.body.attestations) + 3
        label = "http: POST /eth/v1/beacon/blocks (block 31)"
        root, post_calls = calls.step(label, lambda: client.publish_block(b31), [n_sets])
        need(root == root31 and chain.head_root == root31,
             "http: block 31 is not the node's head")
        out["post_block"] = calls.rows[label]
        replay_step(calls, label, post_calls)
        events = sub.join()
        want = [("block", "0x" + root31.hex()), ("head", "0x" + root31.hex())]
        need(sorted((k, p.get("block")) for k, p, _ in events) == want,
             f"http: SSE events {[(k, p.get('block')) for k, p, _ in events]}")
        out["sse_ms"] = {k: (t - emitted[k]) * 1e3 for k, _, t in events}
        reg.twin.import_([b31])
        reg.twin.expect("http", chain, C)

        gets = {}
        for path in HTTP_GET_ROUTES:
            hits0, nm0 = M.SERVING_CACHE_HITS.value, M.SERVING_NOT_MODIFIED.value
            cold = http_request(base + path)
            hot = http_request(base + path)
            hits = M.SERVING_CACHE_HITS.value - hits0
            # the conditional GET reads the cache too, then answers bodyless
            etag = hot[1].get("ETag")
            revalidated = http_request(base + path, headers={"If-None-Match": etag})
            need(cold[0] == hot[0] == 200 and cold[1].get("X-Cache") == "miss"
                 and hot[1].get("X-Cache") == "hit" and hot[2] == cold[2] and hits == 1,
                 f"http: GET {path}: {cold[0]} {cold[1].get('X-Cache')}, then {hot[0]} "
                 f"{hot[1].get('X-Cache')}, equal bodies {hot[2] == cold[2]}, {hits} hits")
            need(revalidated[0] == 304 and not revalidated[2]
                 and M.SERVING_NOT_MODIFIED.value - nm0 == 1,
                 f"http: GET {path} with If-None-Match: {revalidated[0]}")
            gets[path] = dict(bytes=len(cold[2]), cold_ms=cold[3], cached_ms=hot[3],
                              not_modified_ms=revalidated[3])
        rows = json.loads(http_request(base + HTTP_GET_ROUTES[0])[2])["data"]
        committees = json.loads(http_request(base + HTTP_GET_ROUTES[1])[2])["data"]
        n_committees = preset.slots_per_epoch * C.context.ConsensusContext(
            preset, spec).committee_cache(post31, 0).committees_per_slot
        need(len(rows) == len(reg.genesis.validators) and len(committees) == n_committees
             and sum(len(c["validators"]) for c in committees) == len(rows),
             f"http: {len(rows)} validator rows, {len(committees)} committees")
        out["gets"] = gets

        t = time.perf_counter()
        duties = client.get_attester_duties(0, range(len(rows)))
        out["attester_duties_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        proposers = client.get_proposer_duties(0)
        out["proposer_duties_ms"] = (time.perf_counter() - t) * 1e3
        need(sorted(d["validator_index"] for d in duties) == list(range(len(rows)))
             and len(proposers) == preset.slots_per_epoch,
             f"http: {len(duties)} attester duties, {len(proposers)} proposer duties")

        label = "http: POST /eth/v1/beacon/pool/sync_committees"
        _, sync_calls = calls.step(
            label, lambda: [client.publish_sync_message(m, subnet)
                            for m, subnet in msgs[:-1]], [1] * HTTP_SYNC_MESSAGES)
        need(calls.rows[label]["verdicts"] == [True] * HTTP_SYNC_MESSAGES,
             f"http: sync messages {calls.rows[label]['verdicts']}")
        out["sync_messages"] = calls.rows[label]
        replay_step(calls, label, sync_calls[:1])
        refused = []

        def forged():
            try:
                client.publish_sync_message(*msgs[-1])
            except H.Eth2ClientError as e:
                refused.append(str(e))

        label = "http: a forged sync message"
        calls.step(label, forged, [1])
        need(len(refused) == 1 and "sync message rejected" in refused[0]
             and calls.rows[label]["verdicts"] == [False],
             f"http: the forged sync message: {refused}")
        out["forged_sync"] = calls.rows[label]

        shed0 = M.SERVING_SHED_READ_ONLY.value
        pressure["queue_wait_p95_seconds"] = HTTP_PRESSURE_S
        try:
            shed = http_request(base + "/eth/v1/beacon/states/head/validators/0")
            duty = http_request(base + "/eth/v1/validator/duties/attester/0", "POST", ["0"])
        finally:
            pressure.clear()
        need(shed[0] == 503 and shed[1].get("Retry-After") == "1"
             and M.SERVING_SHED_READ_ONLY.value - shed0 == 1 and duty[0] == 200,
             f"http: under pressure a read-only GET gave {shed[0]} "
             f"(Retry-After {shed[1].get('Retry-After')}), a duty POST {duty[0]}")
        out["shed_ms"], out["admitted_duty_ms"] = shed[3], duty[3]
        health = http_request(base + "/lighthouse/health")
        data = json.loads(health[2])["data"]
        need(health[0] == 200 and set(data) == {
            "cpu_process_seconds_total", "memory_process_bytes", "process_open_fds",
            "head_slot"} and data["head_slot"] == str(BLOCK_SLOT),
             f"http: /lighthouse/health {health[0]} {sorted(data)}")
        text = http_request(base + "/metrics")[2].decode()
        missing = [f for f in SERVING_FAMILIES
                   if f"# TYPE {getattr(M, f).name} " not in text]
        need(not missing, f"http: /metrics lacks {missing}")
        out["tier"] = tier.stats()
    finally:
        server.stop()
    log(f"http: MAINNET: the node behind BeaconApiServer ({out['setup_s']:.1f} s with "
        f"the sync messages signed); SSE ms from import to subscriber "
        f"{json.dumps({k: round(v, 2) for k, v in out['sse_ms'].items()})}; GET ms cold / "
        f"cached / 304 "
        f"{json.dumps({p: [round(g['cold_ms'], 1), round(g['cached_ms'], 1), round(g['not_modified_ms'], 1)] for p, g in gets.items()})}"
        f"; attester duties of {len(duties)} validators {out['attester_duties_ms']:.1f} ms, "
        f"proposer duties {out['proposer_duties_ms']:.1f} ms; shed 503 in "
        f"{out['shed_ms']:.1f} ms while a duty POST passed; the head the twin's; "
        f"card: {card}")
    return out


def http_keys(C, reg, calls, card):
    """Part (b): keystores, the keymanager and a remote signer. Interop
    keys in EIP-2335 keystores imported over HTTP through a
    KeymanagerServer into a ValidatorStore (one with a wrong password
    refused), one more key served by a Web3SignerServer and added to the
    store as a Web3SignerMethod; a selection proof of each key through the
    store, all verified in one call, and again with two roots swapped."""
    T, KS, VC = C.types, C.keystore, C.vc
    preset, spec, state = reg.preset, reg.spec, reg.state
    out = {}
    t0 = time.perf_counter()
    sks = [T.interop_secret_key(HTTP_KEY_BASE + i) for i in range(HTTP_KEYSTORES + 1)]
    stores, encrypt_ms = [], []
    for i, sk in enumerate(sks[:-1]):
        t = time.perf_counter()
        stores.append(KS.Keystore.encrypt(
            sk, f"password {i}", path=KS.validator_path(HTTP_KEY_BASE + i),
            kdf="pbkdf2" if i == HTTP_KEYSTORES - 1 else "scrypt",
            scrypt_n=KS.SCRYPT_N_LIGHT))
        encrypt_ms.append((time.perf_counter() - t) * 1e3)
    decrypt_ms = {}
    for kdf, ks, i in (("scrypt", stores[0], 0), ("pbkdf2", stores[-1], HTTP_KEYSTORES - 1)):
        t = time.perf_counter()
        need(ks.decrypt(f"password {i}").to_bytes() == sks[i].to_bytes(),
             f"http: keys: the {kdf} keystore does not give its key back")
        decrypt_ms[kdf] = (time.perf_counter() - t) * 1e3
    store = VC.ValidatorStore(preset, spec)
    km = VC.KeymanagerApi(store, bytes(state.genesis_validators_root))
    km_server = VC.KeymanagerServer(km).start()
    signer = VC.Web3SignerServer([sks[-1]]).start()
    try:
        auth = {"Authorization": f"Bearer {km.api_token}"}
        url = km_server.url + "/eth/v1/keystores"
        body = {"keystores": [ks.to_json() for ks in stores],
                "passwords": ["wrong"] + [f"password {i}" for i in range(1, HTTP_KEYSTORES)]}
        first = http_request(url, "POST", body, auth)
        again = http_request(url, "POST", {"keystores": [stores[0].to_json()],
                                           "passwords": ["password 0"]}, auth)
        listed = http_request(url, headers=auth)
        statuses = [d["status"] for d in json.loads(first[2])["data"]]
        need(first[0] == again[0] == listed[0] == 200
             and statuses == ["error"] + ["imported"] * (HTTP_KEYSTORES - 1)
             and [d["status"] for d in json.loads(again[2])["data"]] == ["imported"],
             f"http: keys: keymanager imports {statuses}, then "
             f"{json.loads(again[2])['data']}")
        local = sorted(d["validating_pubkey"] for d in json.loads(listed[2])["data"])
        need(local == sorted("0x" + sk.public_key().to_bytes().hex() for sk in sks[:-1]),
             "http: keys: the keymanager lists other keys")
        out["import_ms"] = [first[3], again[3]]
        remote = VC.Web3SignerMethod(signer.url, sks[-1].public_key(), timeout_s=HTTP_TIMEOUT_S)
        store.add_validator(remote)
        pks = [sk.public_key().to_bytes() for sk in sks]
        need(sorted(store.voting_pubkeys()) == sorted(pks), "http: keys: the store's keys")
        t = time.perf_counter()
        for _ in range(3):
            remote.sign(b"\x5a" * 32)
        out["web3signer_ms"] = (time.perf_counter() - t) * 1e3 / 3
        slots = [BLOCK_SLOT - i for i in range(len(sks))]
        sigs = [store.sign_selection_proof(pk, slot, state) for pk, slot in zip(pks, slots)]
        roots = [T.SigningData(
            object_root=C.ssz.uint64.hash_tree_root(slot),
            domain=T.get_domain(state, T.DOMAIN_SELECTION_PROOF,
                                slot // preset.slots_per_epoch, preset)).tree_hash_root()
            for slot in slots]
        need(sigs[-1].to_bytes() == sks[-1].sign(roots[-1]).to_bytes(),
             "http: keys: the remote signature differs from the key's own")
        keys = [C.api.PublicKey.from_bytes(pk) for pk in pks]

        def verify(order):
            sets = [C.api.SignatureSet.single_pubkey(sig, key, roots[j])
                    for sig, key, j in zip(sigs, keys, order)]
            return C.api.verify_signature_sets(sets)

        n = len(sks)
        label = "http: keys: the store's and the signer's signatures"
        ok, _ = calls.step(label, lambda: verify(range(n)), [n])
        need(ok is True, "http: keys: the honest signatures were refused")
        out["honest"] = calls.rows[label]
        label = "http: keys: two roots swapped"
        bad, _ = calls.step(label, lambda: verify([1, 0] + list(range(2, n))), [n])
        need(bad is False, "http: keys: the swapped roots were accepted")
        out["swapped"] = calls.rows[label]
    finally:
        signer.stop()
        km_server.stop()
    out.update(encrypt_ms=encrypt_ms, decrypt_ms=decrypt_ms,
               seconds=time.perf_counter() - t0)
    log(f"http: keys: {HTTP_KEYSTORES} keystores (scrypt n=2^14, the last pbkdf2 c=262144) "
        f"encrypted in {json.dumps([round(x, 1) for x in encrypt_ms])} ms, decrypt ms "
        f"{json.dumps({k: round(v, 1) for k, v in decrypt_ms.items()})}; imported over "
        f"HTTP in {json.dumps([round(x, 1) for x in out['import_ms']])} ms, the wrong "
        f"password refused; a Web3Signer round trip {out['web3signer_ms']:.1f} ms; "
        f"{n} signatures True in one call, False with two roots swapped; "
        f"part wall {out['seconds']:.1f} s; card: {card}")
    return out


def http_vc(C, calls, card):
    """Part (c): a ValidatorClient of VC_VALIDATORS distinct interop keys
    over BeaconNodeFallback([a client of a closed port, a live client]) of
    a MINIMAL harness chain (altair at epoch 0, its table on the card)
    behind BeaconApiServer, for one epoch of slots: every block proposed
    over HTTP and imported on the card (one call a slot); then the VC's
    sync-committee messages signed by its store and posted over HTTP
    (the VC itself takes the head root for them from an in-process
    node's chain only). Every head the twin's."""
    T, H, VC, PS = C.types, C.http_api, C.vc, C.per_slot
    preset, spec = T.MINIMAL, T.ChainSpec.interop(altair_fork_epoch=0)
    spe = preset.slots_per_epoch
    out = {}
    t0 = time.perf_counter()
    h = C.harness.BeaconChainHarness(VC_VALIDATORS, preset, spec)
    chain_on_card(C, "http: vc", h.chain)
    genesis = PS.clone_state(h.chain.head_state)
    store = VC.ValidatorStore(preset, spec)
    for i in range(VC_VALIDATORS):
        store.add_validator(VC.LocalKeystore(T.interop_secret_key(i)))
    server = H.BeaconApiServer(H.BeaconApi(VC.InProcessBeaconNode(h.chain)))
    server.start()
    out["setup_s"] = time.perf_counter() - t0
    try:
        live = H.BeaconNodeHttpClient(f"http://127.0.0.1:{server.port}", preset,
                                      timeout=HTTP_TIMEOUT_S)
        dead = H.BeaconNodeHttpClient(f"http://127.0.0.1:{closed_port()}", preset,
                                      timeout=HTTP_TIMEOUT_S)
        probes = []
        healthy = dead.is_healthy
        dead.is_healthy = lambda: probes.append(healthy()) or probes[-1]
        vc = VC.ValidatorClient(store, VC.BeaconNodeFallback([dead, live]), preset, spec,
                                graffiti=HTTP_GRAFFITI)
        views, slot_s = [], []
        for slot in range(1, spe + 1):
            h.chain.slot_clock.set_slot(slot)
            h.chain.on_tick()
            label = f"http: vc: slot {slot}"
            _, step_calls = calls.step(label, lambda: vc.on_slot(slot))
            need(len(step_calls) == 1 and calls.rows[label]["verdicts"] == [True],
                 f"http: vc: slot {slot}: calls {calls.rows[label]['calls']}, verdicts "
                 f"{calls.rows[label]['verdicts']}")
            slot_s.append(calls.rows[label]["seconds"])
            views.append(chain_view(C, h.chain))
        blocks = [h.store.get_block(root) for root in vc.blocks_proposed]
        need(int(h.chain.head_state.slot) == spe and len(blocks) == spe
             and [int(b.message.slot) for b in blocks] == list(range(1, spe + 1)),
             f"http: vc: head at slot {h.chain.head_state.slot}, "
             f"{len(vc.blocks_proposed)} blocks proposed")
        need(not vc.duty_errors, f"http: vc: duty errors {vc.duty_errors}")
        need(len(probes) >= spe and not any(probes),
             f"http: vc: the closed port's health probes {probes}")
        graffiti = bytes(blocks[-1].message.body.graffiti).rstrip(b"\x00")
        need(graffiti == HTTP_GRAFFITI, f"http: vc: the head's graffiti {graffiti!r}")
        need(vc.attestations_published >= VC_VALIDATORS and vc.aggregates_published > 0,
             f"http: vc: {vc.attestations_published} attestations, "
             f"{vc.aggregates_published} aggregates published")

        head = h.chain.head_root
        context = live.signing_context()
        duties = live.get_sync_duties(0, range(VC_VALIDATORS))[:VC_SYNC_MESSAGES]
        msgs = []
        for d in duties:
            pk = vc._pubkey_for_index(d["validator_index"])
            sig = store.sign_sync_committee_message(pk, spe, head, context)
            msgs.append((T.SyncCommitteeMessage(
                slot=spe, beacon_block_root=head, validator_index=d["validator_index"],
                signature=sig.to_bytes()), min(d["subnets"])))
        label = "http: vc: sync messages over HTTP"
        calls.step(label, lambda: [live.publish_sync_message(m, s) for m, s in msgs],
                   [1] * len(msgs))
        need(len(msgs) == VC_SYNC_MESSAGES
             and calls.rows[label]["verdicts"] == [True] * VC_SYNC_MESSAGES,
             f"http: vc: sync messages {calls.rows[label]['verdicts']}")
        out["sync_messages"] = calls.rows[label]
    finally:
        server.stop()
    t = time.perf_counter()
    twin = network_chain(C, genesis, preset, spec)
    NOV = C.per_block.BlockSignatureStrategy.NO_VERIFICATION
    for b, view in zip(blocks, views):
        twin.slot_clock.set_slot(b.message.slot)
        twin.process_block(b, strategy=NOV)
        need(chain_view(C, twin) == view,
             f"http: vc: the head after slot {b.message.slot} differs from the twin's")
    out.update(twin_s=time.perf_counter() - t, slot_s=slot_s,
               failover_probes=len(probes), attestations=vc.attestations_published,
               aggregates=vc.aggregates_published, seconds=time.perf_counter() - t0)
    log(f"http: vc: {spe} slots of {VC_VALIDATORS} validators over HTTP through the "
        f"fallback (the closed port probed and passed over {len(probes)} times): "
        f"{len(blocks)} blocks proposed and imported on the card, "
        f"{vc.attestations_published} attestations and {vc.aggregates_published} "
        f"aggregates published, {VC_SYNC_MESSAGES} sync messages verified, no duty "
        f"error, graffiti {graffiti!r}; s a slot {json.dumps([round(x, 2) for x in slot_s])}"
        f"; every head the twin's ({out['twin_s']:.1f} s); part wall "
        f"{out['seconds']:.1f} s; card: {card}")
    return out


def phase_http(torch, K, TP, B, C, reg, launches, card):
    """The beacon API over HTTP and the validator client on the card:
    part (a) the node's side at MAINNET, part (b) keystores, the
    keymanager and a remote signer, part (c) a MINIMAL validator client
    over HTTP for an epoch; every call's launches held to
    expected_launches and its verdict to the cpu oracle's. Every server
    is stopped before the phase returns."""
    t_phase = time.perf_counter()
    C.tracing.configure(clock=_WallClock())
    calls = Calls(torch, K, TP, B, C, reg.host, launches, card)
    out = dict(mainnet=http_mainnet(C, reg, calls, card))
    out["keys"] = http_keys(C, reg, calls, card)
    out["vc"] = http_vc(C, calls, card)
    out["oracle_wait_s"] = calls.check_oracle("http")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"http: every verdict equal to the cpu oracle's (waited "
        f"{out['oracle_wait_s']:.1f} s); phase wall {out['seconds']:.1f} s; card: {card}")
    return out


# --- the scenario phase: the scenario harness and the fuzzer's corpus -----------

# the pairing families of aggregation_soundness_plan's probes (the fifth,
# speculation-poisoning, audits the confirm seam and makes no pairing)
SCENARIO_PROBE_FAMILIES = ("rogue-key", "weight-collision", "subgroup",
                           "grouping-cancellation")
CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "fuzz_corpus")


def scenario_plan(S, preset):
    """tests/test_scenarios.py's tier-1 plan: 3 nodes and 48 validators at
    MINIMAL, an epoch, an epoch split 1 | 2, two epochs healed."""
    spe = preset.slots_per_epoch
    return S.ScenarioPlan(
        name="partition-small", seed=0, node_count=3, validator_count=48,
        phases=(S.Phase("baseline", slots=spe),
                S.Phase("split", slots=spe, partition=((0,), (1, 2))),
                S.Phase("heal", slots=2 * spe, heal=True)),
        slo=S.SLO(finality_min_epoch=1))


@contextlib.contextmanager
def fresh_health_histograms(M, MON):
    """The process histograms that a scenario report's health block reads
    (`MON.HEALTH_HISTOGRAMS`: the processor's queue wait and the block
    delays), fresh for the block and put back after it. The earlier
    phases' blocks and queues fed them, so without this a run's report
    would hold their p95s mixed with its own, and two runs' reports would
    differ by what the first added."""
    saved = {n: getattr(M, n) for _, n in MON.HEALTH_HISTOGRAMS}
    for n, h in saved.items():
        setattr(M, n, M.Histogram(h.name, h.help, buckets=h.buckets))
    try:
        yield
    finally:
        for n, h in saved.items():
            setattr(M, n, h)


def phase_scenario(torch, K, TP, B, api, launches, card):
    """The scenario harness and the fuzzer with torch_cuda as the caller's
    backend on the card. A scenario swaps the backend to `fake` for its run,
    as in the JAX package (consensus, not pairings), and its aggregation
    probes audit the cpu oracle: so the scenario runs and the corpus
    replays launch no kernel, and the phase's only card work is step 3.
    (1) assert_bit_identical_replay of the small partition plan with every
    node chain on the default device, the card, then the same plan with
    device="cpu": the same report, trace and ledger bytes; after each run
    the backend is torch_cuda on the device set before. (2) Each corpus
    entry replayed: its recorded reason under its plant, clean without it.
    (3) The first batch of each pairing probe family of
    aggregation_soundness_plan (as audit(quick=True) takes it, seed 0)
    through torch_cuda on the card (run_path "torch_aggregated", the
    backend's default switches) and through the cpu oracle: both False,
    the card's launches as its calls' pairs imply."""
    from lighthouse_tpu_torch.crypto.bls import adversary as A
    from lighthouse_tpu_torch.harness import fuzz as F
    from lighthouse_tpu_torch.harness import scenario as S
    from lighthouse_tpu_torch.types import MINIMAL
    from lighthouse_tpu_torch.utils import metrics as M
    from lighthouse_tpu_torch.utils import monitoring as MON

    t_phase = time.perf_counter()
    api.set_backend("torch_cuda")
    caller = (api.get_backend_name(), api._DEVICE)

    def restored(label):
        now = (api.get_backend_name(), api._DEVICE)
        need(now == caller, f"scenario: after {label} the backend is {now}, "
             f"want {caller}")

    plan = scenario_plan(S, MINIMAL)
    memory_before = torch.cuda.memory_allocated()
    K.reset_launches()
    runs = {}
    t = time.perf_counter()
    with fresh_health_histograms(M, MON):
        card_run, card_again = S.assert_bit_identical_replay(plan)
    runs["replay_s"] = time.perf_counter() - t
    restored("the replay")
    t = time.perf_counter()
    with fresh_health_histograms(M, MON):
        cpu_run = S.run_scenario(plan, device="cpu")
    runs["cpu_s"] = time.perf_counter() - t
    restored("the cpu run")
    report = card_run.report
    need(report["slo"]["failures"] == [], f"scenario: SLO failures {report['slo']}")
    need(report["fsck_issues"] == {}, f"scenario: fsck {report['fsck_issues']}")
    need(report["finalized_epoch"] >= 1 and len(report["final_heads"]) == 1,
         f"scenario: finalized {report['finalized_epoch']}, heads {report['final_heads']}")
    need(card_again.report == report, "scenario: the replay's report differs")
    need((cpu_run.report, cpu_run.trace, cpu_run.ledger)
         == (report, card_run.trace, card_run.ledger),
         "scenario: the cpu run's report, trace or ledger differs from the card run's")
    corpus = {}
    for path in sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json"))):
        entry = F.load_corpus_entry(path)
        t = time.perf_counter()
        try:
            F.replay_corpus_entry(entry)
        except AssertionError as e:
            raise Fail(f"scenario: corpus {os.path.basename(path)}: {e}") from e
        corpus[os.path.basename(path)] = dict(
            plant=entry["plant"], reason=entry["reason"], seconds=time.perf_counter() - t)
        restored(f"corpus {os.path.basename(path)}")
    need(len(corpus) >= 2, f"scenario: corpus entries {sorted(corpus)} in {CORPUS_DIR}")
    scenario_launches = dict(K.LAUNCHES)
    need(not any(scenario_launches.values()),
         f"scenario: kernels launched during the scenario runs: {scenario_launches}")
    memory_after = torch.cuda.memory_allocated()

    probes, probe_launches = {}, {}
    for family in SCENARIO_PROBE_FAMILIES:
        batch = A.BATCHES[family](0)[0]
        K.reset_launches()
        t = time.perf_counter()
        with backend_calls(B, M) as calls:
            on_card = A.run_path("torch_aggregated", batch, seed=0)
        secs = time.perf_counter() - t
        counts = dict(K.LAUNCHES)
        want = {}
        for c in calls:
            if c["pairs"]:  # 0: a structural check refused it before the card
                add_launches(want, expected_launches(TP, c["pairs"]))
        if want:
            check_launches(f"scenario {family}", counts, want)
        else:
            need(not any(counts.values()), f"scenario {family}: launches {counts} "
                 "without a device call")
        add_launches(probe_launches, counts)
        on_cpu = A.run_path("cpu", batch, seed=0)
        need(on_card is False and on_cpu is False,
             f"scenario: probe {family} card {on_card}, cpu oracle {on_cpu}")
        probes[family] = dict(sets=len(batch), pairs=[c["pairs"] for c in calls],
                              card=on_card, cpu=on_cpu, seconds=secs)
        log(f"scenario: probe {family}: {len(batch)} sets, pairs "
            f"{probes[family]['pairs']}, card {on_card}, cpu oracle {on_cpu} "
            f"({secs:.3f} s); launches {counts}; card: {card}")
    add_launches(launches, probe_launches)
    restored("the probes")
    slots = report["slots_run"]
    out = dict(
        plan=plan.name, nodes=report["nodes"], validators=report["validators"],
        slots_run=slots, fake_default_device_replay_s=runs["replay_s"],
        fake_cpu_s=runs["cpu_s"],
        fake_default_device_slots_per_s=2 * slots / runs["replay_s"],
        fake_cpu_slots_per_s=slots / runs["cpu_s"],
        finalized_epoch=report["finalized_epoch"], final_heads=report["final_heads"],
        trace_sha256=report["trace_sha256"], ledger_sha256=report["ledger_sha256"],
        corpus=corpus, memory_allocated_before=memory_before,
        memory_allocated_after=memory_after, scenario_launches=scenario_launches,
        probes=probes, probe_launches=probe_launches,
        backend="fake during each run, by design; torch_cuda on the card for the probes",
        seconds=time.perf_counter() - t_phase)
    log(json.dumps({"scenario": out}))
    log(f"scenario: on the fake backend, the replay with the chains on the default "
        f"device {runs['replay_s']:.1f} s (2 runs of {slots} slots), the cpu run "
        f"{runs['cpu_s']:.1f} s, the same bytes; corpus replayed; no kernel launched by "
        f"a scenario; every probe rejected on the card and by the cpu oracle; phase wall "
        f"{out['seconds']:.1f} s; card: {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm verify of each batch")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + CHILD_PHASES:
            raise SystemExit(f"unknown phase {p!r}")
    if any(p in phases for p in ("sync", "pool")) and "chain" not in phases:
        raise SystemExit("the sync and pool phases go on from the chain phase's chain: "
                         "add chain to --phases")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.backends import torch_cuda as B
    from lighthouse_tpu_torch.crypto.bls.gpu import kernels as K
    from lighthouse_tpu_torch.crypto.bls.gpu import pairing as TP
    from lighthouse_tpu_torch.utils import cuda_graphs as CG

    t_start = time.perf_counter()
    card = card_line()
    log(card)  # nvidia-smi's own line: name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    phase_s = {}  # wall seconds of each phase, and of the set-up between them

    def timed(name, fn, *args):
        t = time.perf_counter()
        done = False
        try:
            out = fn(*args)
            done = True
            return out
        finally:
            phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t
            if not done:
                log(json.dumps({"phase_s": phase_s, "failed": name}))

    info = timed("build", K.build)  # always: every later phase needs it
    log(f"build: {info['seconds']:.1f} s, built {info['built']} into {info['dir']}")
    for name, rep in info["ptxas"].items():
        for line in ptxas_summary(rep):
            log(f"ptxas {name}: {line}")

    # the host pool (the phases' host crypto) and the registry's set-up on it
    # start with the run; the twins' worker with the registry
    pool_phases = ("adversary", "genesis", "finality") + REGISTRY_PHASES
    use_registry = any(p in phases for p in REGISTRY_PHASES)
    with contextlib.ExitStack() as stack:
        pool = twins = genesis_job = None
        if any(p in phases for p in pool_phases):
            pool = host_pool()
            stack.callback(pool.shutdown, cancel_futures=True)
        if use_registry:
            # on one worker, beside the phases before the registry's
            genesis_job = pool.submit(_registry_genesis, BLOCK_VALIDATORS,
                                      BLOCK_DISTINCT_KEYS)
            twins = twin_worker()
            stack.callback(twins.shutdown, cancel_futures=True)
        results, launches, paths = {}, {}, {}
        memory_start = memory_line(torch)
        log(f"memory before any capture: {memory_start}")
        if "kernels" in phases:
            timed("kernels", phase_kernels, torch, K, CG, results)
        if "parity" in phases or "graphs" in phases:
            parity = timed("sign", parity_sets, api) + (5,)  # 5 Miller pairs
        if "parity" in phases:
            timed("parity", phase_parity, torch, api, B, parity[0])
        use_gossip = any(p in phases for p in ("gossip", "table", "aggverify", "graphs",
                                               "pipeline", "monolith", "windowed-child"))
        use_aggregate = any(p in phases for p in ("aggregate", "table", "graphs",
                                                  "pipeline", "monolith", "windowed-child"))
        if use_gossip or use_aggregate or "warm" in phases:
            api.set_backend("torch_cuda")
            # (sets, forged, Miller pairs): the gossip batch takes the per-set
            # path (64 + 1 pairs), the aggregate batch the message-aggregated
            # one (32 messages + 1 pairs)
            batches, tagged = {}, {}
            if use_gossip:
                t0 = time.perf_counter()
                batches["gossip"] = timed("sign", gossip_sets, api) + (65,)
                log(f"gossip: signed 64 sets in {time.perf_counter() - t0:.1f} s")
            if use_aggregate:
                t0 = time.perf_counter()
                batches["aggregate"] = timed("sign", aggregate_sets, api) + (33,)
                log(f"aggregate: signed 32 sets in {time.perf_counter() - t0:.1f} s")
            for label in ("gossip", "aggregate"):
                if label in phases:
                    sets, forged, pairs = batches[label]
                    paths[label] = timed(
                        label, run_path, torch, K, TP, B, api, label, sets, forged, pairs,
                        launches, card, args.profile)
            if "warm" in phases:
                paths["warm"] = timed("warm", phase_warm, torch, B, card)
            if "table" in phases:
                paths.update(timed("table", phase_table, torch, K, TP, B, api, batches,
                                   launches, card, tagged))
            if "aggverify" in phases:
                paths["aggverify"] = timed(
                    "aggverify", phase_aggverify, torch, K, TP, B, api, batches["gossip"],
                    launches, card)
            if "graphs" in phases:
                paths["graphs"] = timed(
                    "graphs", phase_graphs, torch, K, TP, B, CG,
                    {"parity": parity, **batches}, launches, card)
            if "pipeline" in phases:
                paths["pipeline"] = timed(
                    "pipeline", phase_pipeline, torch, K, TP, B, api, batches, tagged,
                    launches, card)
            if "monolith" in phases:
                paths["monolith"] = timed(
                    "monolith", phase_monolith, torch, K, TP, B, CG, api, batches, launches,
                    card, args.profile)
            if "windowed-child" in phases:
                paths["windowed-child"] = timed(
                    "windowed-child", phase_windowed_child, torch, K, TP, B, CG, api, batches,
                    launches, card)
            if use_gossip or use_aggregate:
                need(all(launches.get(k, 0) > 0 for k in K.LAUNCHES),
                     f"kernels not launched on the main path: {launches}")
                log(f"kernels {json.dumps(launches)}")

        if "windowed" in phases:
            paths["windowed"] = timed("windowed", phase_windowed, card, launches)
        if "correct" in phases:
            paths["correct"] = timed("correct", phase_correct, torch, K, B, api, launches,
                                     card)
        if "adversary" in phases:
            api.set_backend("torch_cuda")
            paths["adversary"] = timed("adversary", phase_adversary, torch, K, TP, B,
                                       api, launches, card, pool)
        if any(p in phases for p in REGISTRY_PHASES + ("genesis", "finality")):
            api.set_backend("torch_cuda")
            C = consensus_modules()
            shared = {}  # what one phase leaves for a later one: the finality chain
            if use_registry:
                reg = timed("registry", registry, torch, C, HostCrypto(pool), card,
                            genesis_job, twins)
                paths["registry"] = reg.summary
            if "block" in phases:
                paths["block"] = timed("block", phase_block, torch, K, TP, B, C, reg,
                                       launches, card)
            if "attestations" in phases:
                paths["attestations"] = timed("attestations", phase_attestations,
                                              torch, K, B, C, reg, launches, card)
            if "chain" in phases:
                paths["chain"] = timed("chain", phase_chain, torch, K, TP, B, C, reg,
                                       launches, card)
            if "sync" in phases:
                paths["sync"] = timed("sync", phase_sync, torch, K, TP, B, C, reg,
                                      launches, card)
            if "pool" in phases:
                paths["pool"] = timed("pool", phase_pool, torch, K, TP, B, C, reg,
                                      launches, card)
            if "genesis" in phases:
                paths["genesis"] = timed("genesis", phase_genesis, torch, K, TP, B, C,
                                         HostCrypto(pool), launches, card)
            if "finality" in phases:
                paths["finality"] = timed("finality", phase_finality, torch, K, TP, B,
                                          C, HostCrypto(pool), launches, card, shared)
            if "merge" in phases:
                paths["merge"] = timed("merge", phase_merge, torch, K, TP, B, C, reg,
                                       launches, card, twins)
            if "network" in phases:
                paths["network"] = timed("network", phase_network, torch, K, TP, B, C,
                                         reg, shared, launches, card)
            if "http" in phases:
                paths["http"] = timed("http", phase_http, torch, K, TP, B, C, reg,
                                      launches, card)
            if use_registry:
                paths["twin"] = timed("twin", twin_check, reg, card)
        if "scenario" in phases:
            paths["scenario"] = timed("scenario", phase_scenario, torch, K, TP, B, api,
                                      launches, card)

    if results:
        line = []
        for name, r in results.items():
            src, replaces = KERNEL_META[name]
            line.append(dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=launches.get(name, 0), max_abs_err=r["max_abs_err"],
                ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None,
            ))
        log(json.dumps({"kernels": line}))
    if paths:
        log(json.dumps({"paths": paths, "card": card}))
    log(json.dumps({"phase_s": phase_s}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Fail as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    # every process and server of the run is stopped by now, so the
    # interpreter's teardown, which only frees the phases' chain states and
    # graph pools, is skipped: the run's wall counts against its limit
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
