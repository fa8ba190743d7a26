"""Statement fingerprints + cache-key digests for the serving layer.

A plan-cache key must treat ``SELECT  1`` and ``select 1 -- dashboard`` as the
same statement (the repeated-dashboard workload re-sends byte-different text)
while never conflating statements that plan differently. Normalization rides
the engine's OWN lexer: the token stream is re-rendered in canonical form
(keywords/identifiers lowercased, whitespace collapsed, comments dropped,
string/number literals kept verbatim — literals select different rows, so they
stay part of the identity). Anything the lexer rejects falls back to
whitespace-collapsed text: an unlexable statement will fail identically at
parse time on every submission, so a coarser fingerprint only costs a
duplicate cache slot, never a wrong hit.
"""
from __future__ import annotations

import hashlib
import json

# settings that never change what the planner produces: including them in the
# key would only fragment the cache across cosmetic differences. The trace
# props are stripped by the scheduler before the settings reach a digest.
_KEY_IRRELEVANT_SETTINGS = frozenset({
    "ballista.job.name",
    "ballista.serving.tenant",
    "ballista.serving.weight",
    "ballista.serving.tenant_slots",
    # the serving caches' own knobs gate cache USAGE, never what the planner
    # produces — two sessions differing only in cache settings must share
    # plan templates, not fragment the key space
    "ballista.serving.plan_cache",
    "ballista.serving.plan_cache_entries",
    "ballista.serving.result_cache",
    "ballista.serving.result_cache_bytes",
    "ballista.serving.result_max_bytes",
    "ballista.serving.exchange_cache",
    "ballista.serving.exchange_cache_bytes",
    "ballista.serving.exchange_cache_ttl_s",
    "ballista.trace.id",
    "ballista.trace.parent",
    "ballista.trace.enabled",
})


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:24]


def normalize_sql(sql: str) -> str:
    """Canonical single-line rendition of a SQL statement (see module doc)."""
    try:
        from ballista_tpu_torch.sql.lexer import tokenize

        toks = tokenize(sql)
    except Exception:  # noqa: BLE001 - unlexable: coarse fallback (module doc)
        return " ".join(sql.split())
    parts: list[str] = []
    for t in toks:
        if t.kind == "EOF":
            break
        if t.kind == "STRING":
            # re-quote with the escape the lexer decoded, so 'it''s' and the
            # identical literal written differently normalize the same way
            parts.append("'" + t.text.replace("'", "''") + "'")
        elif t.kind == "IDENT":
            # identifiers AND keywords: the parser is case-insensitive for
            # both, so lowercase is the canonical form. QUOTING must be
            # preserved (recovered from the source — the token text alone
            # cannot tell '"order key"' from the distinct statement
            # 'order key', and conflating them would let one statement hit
            # the other's cached plan); the parser treats quoted identifiers
            # case-insensitively too, so lowercase inside quotes is sound.
            if sql[t.pos] == '"':
                parts.append('"' + t.text.lower().replace('"', '""') + '"')
            else:
                parts.append(t.text.lower())
        else:
            parts.append(t.text)
    return " ".join(parts)


def fingerprint_sql(sql: str) -> str:
    """Stable fingerprint of a normalized SQL statement."""
    return _sha(normalize_sql(sql).encode())


def fingerprint_bytes(payload: bytes) -> str:
    """Fingerprint for non-SQL submissions (serialized logical plans)."""
    return _sha(bytes(payload))


def table_defs_digest(table_defs: list) -> str:
    """Digest over the client-shipped table definitions. Schema, file groups
    and row counts all ride the defs, so ANY (de)registration or data refresh
    changes the digest — the scheduler-side catalog-version signal."""
    return _sha(b"\x00".join(sorted(bytes(d) for d in table_defs)))


def settings_digest(settings: dict) -> str:
    """Digest over the planning-relevant session settings."""
    relevant = {
        k: str(v)
        for k, v in settings.items()
        if k not in _KEY_IRRELEVANT_SETTINGS
    }
    return _sha(json.dumps(relevant, sort_keys=True).encode())
