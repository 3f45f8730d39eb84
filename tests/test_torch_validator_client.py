"""The port's keys for the validator client (crypto/keystore.py,
validator_client/{keymanager,signing_method}.py) against the JAX
package's on the CPU, byte for byte:

- EIP-2333 derivation (master key, children, EIP-2334 paths, hkdf_mod_r)
  and the BIP-39 mnemonic and seed on the same inputs: equal integers and
  bytes;
- an EIP-2335 keystore made with a fixed salt, IV and uuid (scrypt and
  pbkdf2) is the same JSON in both packages, each package decrypts the
  other's, and a wrong password is refused alike;
- the keymanager over HTTP (KeymanagerServer): list, import (one
  keystore with a wrong password), a duplicate, remote keys, delete with
  its slashing-protection export and an unauthorized request give equal
  statuses and bodies;
- the same signing root signed through each package's Web3SignerServer
  and Web3SignerMethod gives the same signature bytes; an unknown key and
  an unreachable signer raise Web3SignerError alike.

Every server is stopped in `finally`; every client has a short timeout.
No XLA compile: nothing here verifies a signature."""

import json
import os
import socket
import urllib.error
import urllib.request
import uuid

import pytest

from lighthouse_tpu import types as J
from lighthouse_tpu import validator_client as JV
from lighthouse_tpu.crypto import keystore as JK
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu_torch import types as T
from lighthouse_tpu_torch import validator_client as TV
from lighthouse_tpu_torch.crypto import keystore as TK
from lighthouse_tpu_torch.crypto.bls import api as tapi
from torch_port_util import no_xla_compile

# EIP-2333's published test case 0, and two more seeds
SEEDS = (
    bytes.fromhex("c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e5349553"
                  "1f09a6987599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04"),
    bytes(range(32)),
    b"\x5a" * 48,
)
KEY = 3  # the interop key the keystores and the signer hold
TIMEOUT_S = 5.0
PACKAGES = ((TK, tapi, T, TV), (JK, japi, J, JV))


@pytest.fixture(autouse=True)
def _backends():
    saved = (japi._BACKEND, japi._BACKEND_NAME,
             tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE)
    japi.set_backend("fake")
    tapi.set_backend("fake")
    with no_xla_compile():
        yield
    (japi._BACKEND, japi._BACKEND_NAME,
     tapi._BACKEND, tapi._BACKEND_NAME, tapi._DEVICE) = saved


@pytest.fixture()
def fixed_randomness(monkeypatch):
    """os.urandom(n) n bytes of n (a 32-byte salt, a 16-byte IV) and uuid4
    one value, in both packages (they share the os and uuid modules)."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes([n % 256]) * n)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0x15))


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(url, method="GET", body=None, token=None):
    """(status, parsed body) of one request; an HTTP error is returned."""
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("seed", SEEDS, ids=["eip2333-case0", "range32", "5a48"])
def test_eip2333_derivation_equals_jax(seed):
    got = []
    for K, *_ in PACKAGES:
        master = K.derive_master_sk(seed)
        got.append((
            master, [K.derive_child_sk(master, i) for i in (0, 1, 2**32 - 1)],
            [K.derive_path(seed, K.validator_path(i, kind))
             for i in (0, 7) for kind in ("voting", "withdrawal")],
            K.hkdf_mod_r(seed, b"info")))
    assert got[0] == got[1]
    if seed == SEEDS[0]:  # the published vector
        assert got[0][0] == 6083874454709270928345386274498605044986640685124978867557563392430687146096
    for K, *_ in PACKAGES:
        with pytest.raises(K.KeystoreError):
            K.derive_master_sk(b"short")


def test_mnemonic_and_seed_equal_jax():
    entropy = bytes(range(16, 48))
    got = []
    for K, *_ in PACKAGES:
        words = K.entropy_to_mnemonic(entropy)
        got.append((words, K.validate_mnemonic(words), K.mnemonic_to_seed(words, "tpu")))
    assert got[0] == got[1]
    assert got[0][1] == entropy


@pytest.mark.parametrize("kdf", ["scrypt", "pbkdf2"])
def test_keystore_with_fixed_salt_and_iv_is_byte_equal(kdf, fixed_randomness):
    stores = []
    for K, api, pkg, _ in PACKAGES:
        sk = pkg.interop_secret_key(KEY)
        stores.append(K.Keystore.encrypt(sk, "pass💥word", path=K.validator_path(KEY),
                                         kdf=kdf, description="interop 3"))
    tks, jks = stores
    assert tks.to_json() == jks.to_json()
    assert json.loads(tks.to_json())["crypto"]["kdf"]["function"] == kdf
    # each package decrypts the other's
    back = TK.Keystore.from_json(jks.to_json()).decrypt("pass💥word")
    assert back.to_bytes() == T.interop_secret_key(KEY).to_bytes()
    back = JK.Keystore.from_json(tks.to_json()).decrypt("pass💥word")
    assert back.to_bytes() == J.interop_secret_key(KEY).to_bytes()
    errors = []
    for K, ks in ((TK, tks), (JK, jks)):
        with pytest.raises(K.KeystoreError) as e:
            ks.decrypt("wrong")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "incorrect password (checksum mismatch)"


def _keymanager_session(K, api, pkg, V, keystore_json):
    """Every keymanager route over HTTP on a store holding interop key 1:
    [(status, body)]."""
    spec = pkg.ChainSpec.interop()
    store = V.ValidatorStore(pkg.MINIMAL, spec)
    store.add_validator(V.LocalKeystore(pkg.interop_secret_key(1)))
    km = V.KeymanagerApi(store, b"\x42" * 32)
    server = V.KeymanagerServer(km).start()
    url = server.url + "/eth/v1/keystores"
    try:
        out = [_request(url)]  # no token
        out.append(_request(url, token=km.api_token))
        out.append(_request(url, "POST", {"keystores": [keystore_json, keystore_json],
                                          "passwords": ["wrong", "pw"]}, km.api_token))
        out.append(_request(url, "POST", {"keystores": [keystore_json],
                                          "passwords": ["pw"]}, km.api_token))
        out.append(_request(url, "POST", {"keystores": [keystore_json],
                                          "passwords": []}, km.api_token))
        out.append(_request(url, token=km.api_token))
        out.append(_request(server.url + "/eth/v1/remotekeys", token=km.api_token))
        pk = "0x" + json.loads(keystore_json)["pubkey"]
        out.append(_request(url, "DELETE", {"pubkeys": [pk, "0x" + "ab" * 48]},
                            km.api_token))
        out.append(_request(url, token=km.api_token))
        out.append(_request(server.url + "/eth/v1/unknown", token=km.api_token))
    finally:
        server.stop()
    return out


def test_keymanager_over_http_gives_equal_bodies(fixed_randomness):
    keystore_json = TK.Keystore.encrypt(T.interop_secret_key(KEY), "pw").to_json()
    port = _keymanager_session(*PACKAGES[0], keystore_json)
    jax = _keymanager_session(*PACKAGES[1], keystore_json)
    assert port == jax
    statuses = [status for status, _ in port]
    assert statuses == [401, 200, 200, 200, 400, 200, 200, 200, 200, 404]
    assert [d["status"] for d in port[2][1]["data"]] == ["error", "imported"]
    assert [d["status"] for d in port[3][1]["data"]] == ["duplicate"]
    assert len(port[5][1]["data"]) == 2 and len(port[8][1]["data"]) == 1
    assert [d["status"] for d in port[7][1]["data"]] == ["deleted", "not_found"]
    assert "slashing_protection" in port[7][1]


def test_web3signer_signatures_equal_jax():
    root = bytes(range(32))
    sigs, errors = [], []
    for _, api, pkg, V in PACKAGES:
        sk = pkg.interop_secret_key(KEY)
        server = V.Web3SignerServer([sk]).start()
        try:
            method = V.Web3SignerMethod(server.url, sk.public_key(), timeout_s=TIMEOUT_S)
            sigs.append(method.sign(root).to_bytes())
            assert sigs[-1] == sk.sign(root).to_bytes()
            stranger = V.Web3SignerMethod(server.url, pkg.interop_secret_key(KEY + 1)
                                          .public_key(), timeout_s=TIMEOUT_S)
            with pytest.raises(V.Web3SignerError) as e:
                stranger.sign(root)
            errors.append(str(e.value))
        finally:
            server.stop()
        dead = V.Web3SignerMethod(f"http://127.0.0.1:{_closed_port()}",
                                  sk.public_key(), timeout_s=TIMEOUT_S)
        with pytest.raises(V.Web3SignerError):
            dead.sign(root)
    assert sigs[0] == sigs[1]
    assert errors[0] == errors[1]
