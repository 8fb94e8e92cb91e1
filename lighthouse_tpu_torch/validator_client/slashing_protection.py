"""EIP-3076 slashing protection —
``validator_client/slashing_protection``
(``validator_client/slashing_protection/src/``; port of
``lighthouse_tpu/validator_client/slashing_protection.py``): a SQLite
database of every signed block and attestation, consulted BEFORE every
signature; refuses double blocks, double votes and surround votes; imports
and exports the EIP-3076 interchange format."""

from __future__ import annotations

import json
import sqlite3
import threading


class SlashingProtectionError(ValueError):
    """A signing attempt that would be slashable."""


class SlashingDatabase:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            c = self._conn
            c.execute("""CREATE TABLE IF NOT EXISTS signed_blocks (
                pubkey BLOB NOT NULL, slot INTEGER NOT NULL,
                signing_root BLOB, PRIMARY KEY (pubkey, slot))""")
            c.execute("""CREATE TABLE IF NOT EXISTS signed_attestations (
                pubkey BLOB NOT NULL, source_epoch INTEGER NOT NULL,
                target_epoch INTEGER NOT NULL, signing_root BLOB,
                PRIMARY KEY (pubkey, target_epoch))""")
            c.execute("""CREATE TABLE IF NOT EXISTS metadata (
                key TEXT PRIMARY KEY, value BLOB)""")
            c.commit()

    # -- blocks --------------------------------------------------------------

    def check_and_insert_block_proposal(self, pubkey: bytes, slot: int,
                                        signing_root: bytes) -> None:
        """Refuse any proposal at or below the max seen slot, except an
        exact re-sign of the same root (EIP-3076 rules)."""
        with self._lock:
            row = self._conn.execute(
                "SELECT slot, signing_root FROM signed_blocks WHERE "
                "pubkey=? AND slot=?", (pubkey, slot)).fetchone()
            if row is not None:
                if row[1] == signing_root:
                    return  # identical re-sign is safe
                raise SlashingProtectionError(
                    f"double block proposal at slot {slot}")
            mx = self._conn.execute(
                "SELECT MAX(slot) FROM signed_blocks WHERE pubkey=?",
                (pubkey,)).fetchone()[0]
            if mx is not None and slot <= mx:
                raise SlashingProtectionError(
                    f"proposal slot {slot} not above previous max {mx}")
            self._conn.execute(
                "INSERT INTO signed_blocks (pubkey, slot, signing_root) "
                "VALUES (?,?,?)", (pubkey, slot, signing_root))
            self._conn.commit()

    # -- attestations --------------------------------------------------------

    def check_and_insert_attestation(self, pubkey: bytes, source_epoch: int,
                                     target_epoch: int,
                                     signing_root: bytes) -> None:
        """Double-vote + surround-vote checks (both directions)."""
        if source_epoch > target_epoch:
            raise SlashingProtectionError("source after target")
        with self._lock:
            row = self._conn.execute(
                "SELECT source_epoch, signing_root FROM signed_attestations "
                "WHERE pubkey=? AND target_epoch=?",
                (pubkey, target_epoch)).fetchone()
            if row is not None:
                if row[1] == signing_root and row[0] == source_epoch:
                    return
                raise SlashingProtectionError(
                    f"double vote for target {target_epoch}")
            # This attestation surrounds a previous one.
            surrounded = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE pubkey=? AND "
                "source_epoch>? AND target_epoch<?",
                (pubkey, source_epoch, target_epoch)).fetchone()
            if surrounded:
                raise SlashingProtectionError(
                    f"vote {source_epoch}->{target_epoch} surrounds a "
                    "previous vote")
            # A previous attestation surrounds this one.
            surrounding = self._conn.execute(
                "SELECT 1 FROM signed_attestations WHERE pubkey=? AND "
                "source_epoch<? AND target_epoch>?",
                (pubkey, source_epoch, target_epoch)).fetchone()
            if surrounding:
                raise SlashingProtectionError(
                    f"vote {source_epoch}->{target_epoch} is surrounded by "
                    "a previous vote")
            # Monotonic source guard (interchange minimality).
            mx = self._conn.execute(
                "SELECT MAX(target_epoch) FROM signed_attestations "
                "WHERE pubkey=?", (pubkey,)).fetchone()[0]
            if mx is not None and target_epoch <= mx:
                raise SlashingProtectionError(
                    f"target {target_epoch} not above previous max {mx}")
            self._conn.execute(
                "INSERT INTO signed_attestations (pubkey, source_epoch, "
                "target_epoch, signing_root) VALUES (?,?,?,?)",
                (pubkey, source_epoch, target_epoch, signing_root))
            self._conn.commit()

    # -- EIP-3076 interchange ------------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes) -> str:
        with self._lock:
            data = []
            pubkeys = [r[0] for r in self._conn.execute(
                "SELECT DISTINCT pubkey FROM signed_blocks UNION "
                "SELECT DISTINCT pubkey FROM signed_attestations")]
            for pk in pubkeys:
                blocks = [{"slot": str(s),
                           "signing_root": "0x" + (sr or b"").hex()}
                          for s, sr in self._conn.execute(
                              "SELECT slot, signing_root FROM signed_blocks "
                              "WHERE pubkey=? ORDER BY slot", (pk,))]
                atts = [{"source_epoch": str(se), "target_epoch": str(te),
                         "signing_root": "0x" + (sr or b"").hex()}
                        for se, te, sr in self._conn.execute(
                            "SELECT source_epoch, target_epoch, signing_root "
                            "FROM signed_attestations WHERE pubkey=? "
                            "ORDER BY target_epoch", (pk,))]
                data.append({"pubkey": "0x" + pk.hex(),
                             "signed_blocks": blocks,
                             "signed_attestations": atts})
        return json.dumps({
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root":
                    "0x" + genesis_validators_root.hex()},
            "data": data})

    def import_interchange(self, payload: str,
                           genesis_validators_root: bytes) -> int:
        obj = json.loads(payload)
        gvr = obj["metadata"]["genesis_validators_root"]
        if bytes.fromhex(gvr[2:]) != genesis_validators_root:
            raise SlashingProtectionError(
                "interchange genesis_validators_root mismatch")
        n = 0
        with self._lock:
            for entry in obj["data"]:
                pk = bytes.fromhex(entry["pubkey"][2:])
                for b in entry.get("signed_blocks", []):
                    self._conn.execute(
                        "INSERT OR IGNORE INTO signed_blocks "
                        "(pubkey, slot, signing_root) VALUES (?,?,?)",
                        (pk, int(b["slot"]),
                         bytes.fromhex(b.get("signing_root",
                                             "0x")[2:] or "")))
                    n += 1
                for a in entry.get("signed_attestations", []):
                    self._conn.execute(
                        "INSERT OR IGNORE INTO signed_attestations "
                        "(pubkey, source_epoch, target_epoch, signing_root) "
                        "VALUES (?,?,?,?)",
                        (pk, int(a["source_epoch"]), int(a["target_epoch"]),
                         bytes.fromhex(a.get("signing_root",
                                             "0x")[2:] or "")))
                    n += 1
            self._conn.commit()
        return n
