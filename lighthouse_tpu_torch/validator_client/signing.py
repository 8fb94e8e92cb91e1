"""Signing methods: local keystore vs web3signer remote signing —
``validator_client/src/signing_method.rs:78-89`` (the ``SigningMethod``
enum whose variants share one ``get_signature`` seam; port of
``lighthouse_tpu/validator_client/signing.py``).

The remote method speaks the Consensys web3signer HTTP protocol
(``POST /api/v1/eth2/sign/{pubkey}`` with a typed JSON body carrying the
signing root and fork info); the local method holds the decrypted secret
key.  ``ValidatorStore`` computes roots and enforces slashing protection
identically for both — remote signing changes WHERE the key lives, not
what may be signed.
"""

from __future__ import annotations

import http.client
import json
from typing import Optional
from urllib.parse import urlparse

from ..crypto import bls


class SigningError(RuntimeError):
    pass


class LocalKeystore:
    """In-process secret key (`signing_method.rs` SigningMethod::LocalKeystore)."""

    def __init__(self, sk: bls.SecretKey):
        self.sk = sk

    @property
    def pubkey(self) -> bytes:
        return self.sk.public_key().serialize()

    def sign(self, signing_root: bytes, *, msg_type: str = "",
             fork_info: Optional[dict] = None,
             extra: Optional[dict] = None) -> bytes:
        return self.sk.sign(signing_root).serialize()


class Web3SignerMethod:
    """Remote signer (`signing_method.rs` SigningMethod::Web3Signer).

    One persistent connection per signer URL; the key never enters this
    process.  ``msg_type`` follows the web3signer API enum (BLOCK_V2,
    ATTESTATION, RANDAO_REVEAL, SYNC_COMMITTEE_MESSAGE, ...).
    """

    def __init__(self, url: str, pubkey: bytes, timeout: float = 5.0):
        self.url = url.rstrip("/")
        self._pubkey = pubkey
        self.timeout = timeout
        self._parsed = urlparse(self.url)
        self._conn: Optional[http.client.HTTPConnection] = None

    @property
    def pubkey(self) -> bytes:
        return self._pubkey

    def sign(self, signing_root: bytes, *, msg_type: str = "",
             fork_info: Optional[dict] = None,
             extra: Optional[dict] = None) -> bytes:
        body = {"type": msg_type or "AGGREGATION_SLOT",
                "signingRoot": "0x" + bytes(signing_root).hex()}
        if fork_info:
            body["fork_info"] = fork_info
        if extra:
            body.update(extra)
        path = (f"{self._parsed.path}/api/v1/eth2/sign/"
                f"0x{self._pubkey.hex()}")
        payload = json.dumps(body)
        headers = {"Content-Type": "application/json",
                   "Accept": "application/json"}
        for attempt in (0, 1):
            conn = self._conn
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._parsed.hostname or "127.0.0.1",
                    self._parsed.port or 9000, timeout=self.timeout)
            try:
                conn.request("POST", path, payload, headers)
                resp = conn.getresponse()
                data = resp.read()
                self._conn = conn
                break
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                self._conn = None
                if attempt:
                    raise SigningError(f"web3signer transport failure: {e}")
        if resp.status == 404:
            raise SigningError("web3signer: key not found")
        if resp.status == 412:
            raise SigningError("web3signer: slashing-protection veto")
        if resp.status != 200:
            raise SigningError(f"web3signer: HTTP {resp.status}")
        text = data.decode().strip()
        if text.startswith("{"):
            text = json.loads(text).get("signature", "")
        if not text.startswith("0x"):
            raise SigningError(f"web3signer: malformed response {text[:40]!r}")
        return bytes.fromhex(text[2:])
