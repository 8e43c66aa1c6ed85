"""String object-id <-> int32 interning (copy of spatialflink_tpu.utils.interner).

Device kernels key dedup/top-k by integer object ids; the host keeps the
string mapping (the reference keys state by the raw ``objID`` string)."""

from __future__ import annotations

from typing import Dict, List


class IdInterner:
    def __init__(self) -> None:
        self._to_int: Dict[str, int] = {}
        self._to_str: List[str] = []

    def intern(self, obj_id: str) -> int:
        idx = self._to_int.get(obj_id)
        if idx is None:
            idx = len(self._to_str)
            self._to_int[obj_id] = idx
            self._to_str.append(obj_id)
        return idx

    def lookup(self, idx: int) -> str:
        return self._to_str[idx]

    def __len__(self) -> int:
        return len(self._to_str)

    def to_list(self) -> List[str]:
        """Id-ordered strings for checkpointing (index == interned id)."""
        return list(self._to_str)

    @classmethod
    def from_list(cls, ids: List[str]) -> "IdInterner":
        out = cls()
        for s in ids:
            out.intern(str(s))
        return out

    def restore(self, ids: List[str]) -> None:
        """Make this interner (in place: its holders keep it) the one
        :meth:`to_list` gave ``ids``."""
        fresh = self.from_list(ids)
        self._to_int, self._to_str = fresh._to_int, fresh._to_str
