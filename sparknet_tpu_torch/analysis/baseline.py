"""Committed-baseline support: legacy findings don't block CI, new ones do.

The baseline file (default ``.sparknet-lint-baseline.json``, committed
at the repo root) maps finding fingerprints — code + path + symbol +
message, never line numbers, so edits elsewhere in the file don't
invalidate entries — to a written justification. The contract:

  * a finding whose fingerprint is in the baseline is reported as
    "baselined" and does not fail the run
  * every entry must carry a non-empty justification (``--strict``
    fails on placeholder ones) — the baseline is a ledger of accepted
    debt, not a mute button
  * entries whose finding no longer exists are STALE: reported always,
    fatal under ``--strict``, and dropped by ``--write-baseline`` — the
    baseline can only shrink by itself, never silently rot

``sparknet lint --write-baseline --justification "..."`` adds the
current unbaselined findings (and expires stale entries) in one step.
"""

import json
import os

PLACEHOLDER = "TODO: justify"


class Baseline:
    def __init__(self, path=None, entries=None):
        self.path = path
        self.entries = dict(entries or {})   # fingerprint -> entry dict

    @classmethod
    def load(cls, path):
        """Load a baseline file; a missing file is an empty baseline
        (first run bootstraps), a malformed one raises ValueError —
        silently ignoring a corrupt baseline would un-suppress nothing
        and hide everything."""
        if not path or not os.path.exists(path):
            return cls(path)
        with open(path) as f:
            try:
                data = json.load(f)
            except ValueError as e:
                raise ValueError(f"{path}: malformed baseline: {e}")
        if not isinstance(data, dict) or \
                not isinstance(data.get("entries", {}), dict):
            raise ValueError(f"{path}: malformed baseline: expected an "
                             "object with an 'entries' object")
        return cls(path, data.get("entries", {}))

    def split(self, findings):
        """Partition findings into (new, baselined) and compute the
        stale entries (fingerprints with no live finding)."""
        new, baselined, live = [], [], set()
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                baselined.append(f)
                live.add(fp)
            else:
                new.append(f)
        stale = {fp: e for fp, e in self.entries.items() if fp not in live}
        return new, baselined, stale

    def unjustified(self):
        """Entries with an empty or placeholder justification."""
        return {fp: e for fp, e in self.entries.items()
                if not str(e.get("justification", "")).strip()
                or e.get("justification") == PLACEHOLDER}

    def update(self, findings, justification=None):
        """Rewrite the entry set from ``findings``: new findings are
        added with ``justification`` (or the placeholder), existing
        entries keep their justification, stale ones expire. Returns
        (added, expired) counts."""
        new_entries, added = {}, 0
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                new_entries[fp] = self.entries[fp]
                continue
            added += 1
            new_entries[fp] = {
                "code": f.code, "path": f.path, "symbol": f.symbol,
                "message": f.message,
                "justification": justification or PLACEHOLDER,
            }
        expired = len(self.entries) - (len(new_entries) - added)
        self.entries = new_entries
        return added, expired

    def save(self, path=None):
        path = path or self.path
        data = {
            "comment": "sparknet lint baseline — accepted findings with "
                       "justifications; see README 'Static analysis'. "
                       "Entries expire via --write-baseline when the "
                       "finding disappears.",
            "entries": {fp: self.entries[fp]
                        for fp in sorted(self.entries)},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)
        return path
