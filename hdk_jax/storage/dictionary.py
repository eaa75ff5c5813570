"""String dictionary: host-side string <-> int32 code mapping.

Analog of the reference's StringDictionary
(reference: omniscidb/StringDictionary/StringDictionary.h:79,118-135).
Strings never live on the device; device columns hold int32 codes and all
string-valued compute is either done in code space (equality, IN, dict
translation) or on the host (LIKE on the dictionary, then code-space
membership on device).  This is the same split the reference uses for
dict-encoded text on GPU.

Two backends:
  * native (default when buildable): C++ interning map compiled from
    native/strdict.cpp — the analog of the reference's C++
    open-addressing map with bulk encode (getOrAddBulk).
  * pure Python fallback: dict + list.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

import numpy as np

from .native import load_native

NULL_CODE = np.int32(np.iinfo(np.int32).min)  # matches inline int32 null


class _PyBackend:
    __slots__ = ("strings", "codes")

    def __init__(self) -> None:
        self.strings: List[str] = []
        self.codes: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.strings)

    def get_or_add(self, s: str) -> int:
        code = self.codes.get(s)
        if code is None:
            code = len(self.strings)
            self.strings.append(s)
            self.codes[s] = code
        return code

    def get_code(self, s: str) -> int:
        return self.codes.get(s, -1)

    def get_string(self, code: int) -> str:
        return self.strings[code]

    def bulk_get_or_add(self, values) -> np.ndarray:
        out = np.empty(len(values), dtype=np.int32)
        for i, s in enumerate(values):
            out[i] = NULL_CODE if s is None else self.get_or_add(s)
        return out

    def bulk_get_code(self, values) -> np.ndarray:
        out = np.empty(len(values), dtype=np.int32)
        for i, s in enumerate(values):
            out[i] = NULL_CODE if s is None else self.codes.get(s, -1)
        return out

    def bulk_decode(self, codes: np.ndarray) -> List[Optional[str]]:
        return [None if c == NULL_CODE else self.strings[c] for c in codes]

    def all_strings(self) -> List[str]:
        return list(self.strings)


class _NativeBackend:
    __slots__ = ("mod", "handle")

    def __init__(self, mod) -> None:
        self.mod = mod
        self.handle = mod.dict_new()

    def __len__(self) -> int:
        return self.mod.dict_len(self.handle)

    def get_or_add(self, s: str) -> int:
        return self.mod.dict_get_or_add(self.handle, s)

    def get_code(self, s: str) -> int:
        return self.mod.dict_get_code(self.handle, s)

    def get_string(self, code: int) -> str:
        return self.mod.dict_get_string(self.handle, code)

    def bulk_get_or_add(self, values) -> np.ndarray:
        raw = self.mod.dict_bulk_get_or_add(self.handle, values)
        return np.frombuffer(raw, dtype=np.int32).copy()

    def bulk_decode(self, codes: np.ndarray) -> List[Optional[str]]:
        return self.mod.dict_bulk_decode(
            self.handle, np.ascontiguousarray(codes, dtype=np.int32).tobytes())

    def bulk_get_code(self, values) -> np.ndarray:
        raw = self.mod.dict_bulk_get_code(self.handle, values)
        return np.frombuffer(raw, dtype=np.int32).copy()

    def all_strings(self) -> List[str]:
        return self.mod.dict_all_strings(self.handle)


def _make_backend():
    mod = load_native()
    return _NativeBackend(mod) if mod is not None else _PyBackend()


class StringDictionary:
    """Append-only string<->int32 map (codes are dense, starting at 0)."""

    def __init__(self, dict_id: int) -> None:
        self.dict_id = dict_id
        self._b = _make_backend()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._b)

    # -- write path (reference: StringDictionary::getOrAdd / getOrAddBulk) --
    def get_or_add(self, s: Optional[str]) -> int:
        if s is None:
            return int(NULL_CODE)
        with self._lock:
            return self._b.get_or_add(s)

    def bulk_get_or_add(self, values: Iterable[Optional[str]]) -> np.ndarray:
        """Vectorized encode; returns int32 codes with NULL_CODE for None."""
        vals = values if isinstance(values, list) else list(values)
        with self._lock:
            return self._b.bulk_get_or_add(vals)

    # -- read path (reference: StringDictionary::getString / getBulk) -------
    def get_string(self, code: int) -> Optional[str]:
        if code == NULL_CODE:
            return None
        return self._b.get_string(int(code))

    def get_code(self, s: str) -> int:
        """Existing code or -1 (reference: StringDictionary::getIdOfString)."""
        return self._b.get_code(s)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """int32 codes -> object array of str/None."""
        codes = np.asarray(codes)
        out = np.empty(codes.shape, dtype=object)
        out[:] = self._b.bulk_decode(codes.ravel())
        return out

    def all_strings(self) -> List[str]:
        return self._b.all_strings()

    def replace_contents(self, strings: List[str]) -> None:
        """Rebuild the dictionary with a new canonical string order
        (multi-controller unification, parallel/mesh.py: every process
        adopts the rank-ordered union so code spaces agree globally;
        reference role: StringDictionaryTranslationMgr's translated
        id space)."""
        with self._lock:
            self._b = _make_backend()
            if strings:
                # bulk intern: codes 0..n-1 in list order (parallel in
                # the native backend)
                self._b.bulk_get_or_add(list(strings))

    # -- code-space predicates (reference: StringDictionary::getLike /
    #    getRegexpLike run on the dictionary, result used as an IN-set) -----
    def codes_matching(self, pred) -> np.ndarray:
        """Codes whose string satisfies a host predicate (LIKE/REGEXP)."""
        return np.asarray(
            [c for c, s in enumerate(self.all_strings()) if pred(s)],
            dtype=np.int32)

    def translate_to(self, other: "StringDictionary",
                     add_missing: bool = False) -> np.ndarray:
        """Per-code translation map into ``other`` (reference:
        StringDictionaryProxy translation maps, Execute.h:305-315).
        Missing strings map to NULL_CODE unless ``add_missing``."""
        strings = self.all_strings()
        if add_missing:
            with other._lock:
                return other._b.bulk_get_or_add(strings)
        out = other._b.bulk_get_code(strings)
        out[out < 0] = NULL_CODE
        return out


class DictionaryRegistry:
    """Owner of all dictionaries, keyed by dict id (reference:
    DataProvider/DictDescriptor.h + ArrowStorage dict management)."""

    def __init__(self) -> None:
        self._dicts: Dict[int, StringDictionary] = {}
        self._next_id = 1
        self._lock = threading.Lock()

    def create(self) -> StringDictionary:
        with self._lock:
            dict_id = self._next_id
            self._next_id += 1
            d = StringDictionary(dict_id)
            self._dicts[dict_id] = d
            return d

    def get(self, dict_id: int) -> StringDictionary:
        return self._dicts[dict_id]
