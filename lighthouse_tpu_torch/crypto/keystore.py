"""EIP-2335 encrypted keystores, EIP-2333 key derivation, EIP-2386 wallets
(reference crypto/eth2_keystore, crypto/eth2_key_derivation,
crypto/eth2_wallet).

Keystores: scrypt or pbkdf2 KDF (stdlib hashlib), AES-128-CTR cipher,
sha256 checksum -- the exact EIP-2335 JSON schema. Derivation: the
EIP-2333 HKDF/lamport tree with m/12381/3600/i/0/0 paths. Wallets: the
EIP-2386 hierarchical JSON with a nextaccount counter.

The port's copy of lighthouse_tpu/crypto/keystore.py.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import uuid as uuid_mod

from .aes import aes128_ctr
from .bls.api import SecretKey
from .bls.constants import R


class KeystoreError(ValueError):
    pass


# --- EIP-2333 key derivation -----------------------------------------------


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    salt = b"BLS-SIG-KEYGEN-SALT-"
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes) -> list[bytes]:
    okm = _hkdf_expand(_hkdf_extract(salt, ikm), b"", 255 * 32)
    return [okm[i : i + 32] for i in range(0, 255 * 32, 32)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport = _ikm_to_lamport_sk(ikm, salt) + _ikm_to_lamport_sk(not_ikm, salt)
    return hashlib.sha256(
        b"".join(hashlib.sha256(chunk).digest() for chunk in lamport)
    ).digest()


def derive_master_sk(seed: bytes) -> int:
    if len(seed) < 32:
        raise KeystoreError("seed must be >= 32 bytes (EIP-2333)")
    return hkdf_mod_r(seed)


def derive_child_sk(parent_sk: int, index: int) -> int:
    return hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path(seed: bytes, path: str) -> int:
    """m/12381/3600/... EIP-2334 path derivation."""
    parts = path.strip().split("/")
    if parts[0] != "m":
        raise KeystoreError(f"path must start with m: {path}")
    sk = derive_master_sk(seed)
    for part in parts[1:]:
        if not part.isdigit():
            raise KeystoreError(f"bad path component {part!r}")
        sk = derive_child_sk(sk, int(part))
    return sk


def validator_path(index: int, kind: str = "voting") -> str:
    """EIP-2334: m/12381/3600/<index>/0 withdrawal, /0/0 voting."""
    base = f"m/12381/3600/{index}/0"
    return base + "/0" if kind == "voting" else base


# --- EIP-2335 keystore ------------------------------------------------------

# test-friendly scrypt params (2^14); production uses 2^18 like the spec
SCRYPT_N_LIGHT = 1 << 14
SCRYPT_N_FULL = 1 << 18


class Keystore:
    def __init__(self, payload: dict):
        self.payload = payload

    @classmethod
    def encrypt(
        cls,
        secret_key: SecretKey,
        password: str,
        path: str = "",
        kdf: str = "scrypt",
        scrypt_n: int = SCRYPT_N_LIGHT,
        description: str = "",
    ) -> "Keystore":
        salt = os.urandom(32)
        iv = os.urandom(16)
        secret = secret_key.to_bytes()
        if kdf == "scrypt":
            dk = hashlib.scrypt(
                password.encode(), salt=salt, n=scrypt_n, r=8, p=1,
                dklen=32, maxmem=2**31 - 1,
            )
            kdf_module = {
                "function": "scrypt",
                "params": {
                    "dklen": 32, "n": scrypt_n, "r": 8, "p": 1,
                    "salt": salt.hex(),
                },
                "message": "",
            }
        elif kdf == "pbkdf2":
            dk = hashlib.pbkdf2_hmac(
                "sha256", password.encode(), salt, 262144, dklen=32
            )
            kdf_module = {
                "function": "pbkdf2",
                "params": {
                    "dklen": 32, "c": 262144, "prf": "hmac-sha256",
                    "salt": salt.hex(),
                },
                "message": "",
            }
        else:
            raise KeystoreError(f"unsupported kdf {kdf}")
        cipher_message = aes128_ctr(dk[:16], iv, secret)
        checksum = hashlib.sha256(dk[16:32] + cipher_message).digest()
        payload = {
            "crypto": {
                "kdf": kdf_module,
                "checksum": {
                    "function": "sha256", "params": {},
                    "message": checksum.hex(),
                },
                "cipher": {
                    "function": "aes-128-ctr",
                    "params": {"iv": iv.hex()},
                    "message": cipher_message.hex(),
                },
            },
            "description": description,
            "pubkey": secret_key.public_key().to_bytes().hex(),
            "path": path,
            "uuid": str(uuid_mod.uuid4()),
            "version": 4,
        }
        return cls(payload)

    def decrypt(self, password: str) -> SecretKey:
        crypto = self.payload["crypto"]
        kdf = crypto["kdf"]
        salt = bytes.fromhex(kdf["params"]["salt"])
        if kdf["function"] == "scrypt":
            p = kdf["params"]
            dk = hashlib.scrypt(
                password.encode(), salt=salt, n=p["n"], r=p["r"], p=p["p"],
                dklen=p["dklen"], maxmem=2**31 - 1,
            )
        elif kdf["function"] == "pbkdf2":
            p = kdf["params"]
            dk = hashlib.pbkdf2_hmac(
                "sha256", password.encode(), salt, p["c"], dklen=p["dklen"]
            )
        else:
            raise KeystoreError(f"unsupported kdf {kdf['function']}")
        cipher_message = bytes.fromhex(crypto["cipher"]["message"])
        checksum = hashlib.sha256(dk[16:32] + cipher_message).digest()
        # constant-time compare: a timing oracle on the checksum would leak
        # password-correctness bytewise (reference uses fixed-time eq)
        if not hmac.compare_digest(
            checksum, bytes.fromhex(crypto["checksum"]["message"])
        ):
            raise KeystoreError("incorrect password (checksum mismatch)")
        iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
        secret = aes128_ctr(dk[:16], iv, cipher_message)
        sk = SecretKey.from_bytes(secret)
        # verify the decrypted secret against the stored pubkey: a corrupted
        # keystore must not hand back a mismatched signing key
        stored_pk = self.payload.get("pubkey")
        if stored_pk:
            normalized = stored_pk.removeprefix("0x").lower()
            if sk.public_key().to_bytes().hex() != normalized:
                raise KeystoreError("decrypted secret does not match pubkey")
        return sk

    @property
    def pubkey(self) -> str:
        return self.payload["pubkey"]

    def to_json(self) -> str:
        return json.dumps(self.payload)

    @classmethod
    def from_json(cls, payload: str) -> "Keystore":
        data = json.loads(payload)
        if data.get("version") != 4:
            raise KeystoreError("only EIP-2335 version 4 supported")
        return cls(data)


# --- EIP-2386 wallet --------------------------------------------------------


class Wallet:
    """Hierarchical deterministic wallet: one seed, numbered validator
    accounts at EIP-2334 paths, seed stored as an EIP-2335-style blob."""

    def __init__(self, payload: dict, seed: bytes | None = None):
        self.payload = payload
        self._seed = seed

    @classmethod
    def create(
        cls, name: str, password: str, seed: bytes | None = None
    ) -> "Wallet":
        seed = seed if seed is not None else os.urandom(32)
        seed_store = Keystore.encrypt(
            _SeedCarrier(seed), password, path="", kdf="scrypt"
        )
        payload = {
            "crypto": seed_store.payload["crypto"],
            "name": name,
            "nextaccount": 0,
            "type": "hierarchical deterministic",
            "uuid": str(uuid_mod.uuid4()),
            "version": 1,
        }
        return cls(payload, seed)

    def unlock_seed(self, password: str) -> bytes:
        ks = Keystore({"crypto": self.payload["crypto"], "version": 4})
        return _SeedCarrier.extract(ks, password)

    def next_validator(
        self, wallet_password: str, keystore_password: str
    ) -> Keystore:
        """Derive the next account's voting key and wrap it in a keystore
        (eth2_wallet's next_account)."""
        seed = self.unlock_seed(wallet_password)
        index = self.payload["nextaccount"]
        path = validator_path(index, "voting")
        sk = SecretKey(derive_path(seed, path))
        self.payload["nextaccount"] = index + 1
        return Keystore.encrypt(sk, keystore_password, path=path)

    @classmethod
    def recover(
        cls,
        name: str,
        password: str,
        mnemonic: str | None = None,
        seed: bytes | None = None,
        wordlist: list[str] | None = None,
        passphrase: str = "",
    ) -> "Wallet":
        """Rebuild a wallet from its recovery secret (reference
        account_manager wallet recover, eth2_wallet_manager): either a
        BIP-39 mnemonic (checksum-verified against `wordlist`) or the raw
        seed. The recovered wallet derives the SAME validator keys at the
        same EIP-2334 paths; `nextaccount` restarts at 0 and accounts are
        re-derived in order."""
        if (mnemonic is None) == (seed is None):
            raise KeystoreError("recover needs exactly one of mnemonic/seed")
        if mnemonic is not None:
            validate_mnemonic(mnemonic, wordlist)
            seed = mnemonic_to_seed(mnemonic, passphrase)
        return cls.create(name, password, seed=seed)

    def to_json(self) -> str:
        return json.dumps(self.payload)

    @classmethod
    def from_json(cls, payload: str) -> "Wallet":
        return cls(json.loads(payload))


# -- BIP-39 mechanics (reference eth2_wallet's bip39 dependency) -------------
# The algorithm (entropy -> checksummed word indices -> PBKDF2-HMAC-SHA512
# seed) is implemented bit-exactly per the BIP; the 2048-word English list
# is DATA, injected by callers (load the official english.txt for real
# interop) with a deterministic placeholder fallback so the mechanics are
# testable offline.


def placeholder_wordlist() -> list[str]:
    """2048 distinct, prefix-unambiguous tokens. NOT the official BIP-39
    English list: mnemonics built from it round-trip within this
    implementation but are not interchangeable with other wallets."""
    return [f"word{i:04d}" for i in range(2048)]


def entropy_to_mnemonic(entropy: bytes, wordlist: list[str] | None = None) -> str:
    if len(entropy) not in (16, 20, 24, 28, 32):
        raise KeystoreError("entropy must be 128-256 bits in 32-bit steps")
    words = wordlist if wordlist is not None else placeholder_wordlist()
    if len(words) != 2048:
        raise KeystoreError("wordlist must hold exactly 2048 words")
    cs_bits = len(entropy) // 4
    checksum = hashlib.sha256(entropy).digest()
    bits = int.from_bytes(entropy, "big")
    bits = (bits << cs_bits) | (checksum[0] >> (8 - cs_bits))
    total = len(entropy) * 8 + cs_bits
    out = []
    for i in range(total // 11):
        idx = (bits >> (total - 11 * (i + 1))) & 0x7FF
        out.append(words[idx])
    return " ".join(out)


def validate_mnemonic(mnemonic: str, wordlist: list[str] | None = None) -> bytes:
    """Checksum-verify; returns the entropy."""
    words = wordlist if wordlist is not None else placeholder_wordlist()
    if len(words) != 2048:
        raise KeystoreError("wordlist must hold exactly 2048 words")
    index = {w: i for i, w in enumerate(words)}
    parts = mnemonic.split()
    if len(parts) not in (12, 15, 18, 21, 24):
        raise KeystoreError(f"bad mnemonic length {len(parts)}")
    bits = 0
    for w in parts:
        if w not in index:
            raise KeystoreError(f"unknown mnemonic word {w!r}")
        bits = (bits << 11) | index[w]
    total = len(parts) * 11
    cs_bits = total // 33
    ent_bits = total - cs_bits
    entropy = (bits >> cs_bits).to_bytes(ent_bits // 8, "big")
    checksum = bits & ((1 << cs_bits) - 1)
    expected = hashlib.sha256(entropy).digest()[0] >> (8 - cs_bits)
    if checksum != expected:
        raise KeystoreError("mnemonic checksum mismatch")
    return entropy


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    """PBKDF2-HMAC-SHA512, 2048 rounds, salt 'mnemonic'+passphrase, 64
    bytes (the BIP-39 seed derivation, wordlist-independent)."""
    return hashlib.pbkdf2_hmac(
        "sha512",
        mnemonic.encode("utf-8"),
        b"mnemonic" + passphrase.encode("utf-8"),
        2048,
        dklen=64,
    )


class _SeedCarrier:
    """Adapter letting Keystore.encrypt wrap a raw wallet seed (32 bytes
    from create(); 64 from BIP-39 recovery)."""

    def __init__(self, seed: bytes):
        # EIP-2333 master derivation needs >= 32 bytes; BIP-39 seeds are 64
        if not 32 <= len(seed) <= 64:
            raise KeystoreError("wallet seed must be 32-64 bytes")
        self._seed = seed

    def to_bytes(self) -> bytes:
        return self._seed

    def public_key(self):
        class _NoPub:
            @staticmethod
            def to_bytes():
                return b""

        return _NoPub()

    @staticmethod
    def extract(keystore: Keystore, password: str) -> bytes:
        crypto = keystore.payload["crypto"]
        kdf = crypto["kdf"]
        salt = bytes.fromhex(kdf["params"]["salt"])
        if kdf["function"] == "scrypt":
            p = kdf["params"]
            dk = hashlib.scrypt(
                password.encode(), salt=salt, n=p["n"], r=p["r"], p=p["p"],
                dklen=p["dklen"], maxmem=2**31 - 1,
            )
        else:
            p = kdf["params"]
            dk = hashlib.pbkdf2_hmac(
                "sha256", password.encode(), salt, p["c"], dklen=p["dklen"]
            )
        cipher_message = bytes.fromhex(crypto["cipher"]["message"])
        checksum = hashlib.sha256(dk[16:32] + cipher_message).digest()
        if checksum.hex() != crypto["checksum"]["message"]:
            raise KeystoreError("incorrect wallet password")
        iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
        return aes128_ctr(dk[:16], iv, cipher_message)
