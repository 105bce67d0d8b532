"""Read an OCDBT key-value store without tensorstore.

Orbax's ``StandardCheckpointer`` (JAX ``checkpoints.py:95-121``, every
multi-process run) writes each array into tensorstore's OCDBT format:
a B+tree of keys and values in content-addressed data files. The card's
machine has neither tensorstore nor zstandard, so the port reads the
format itself (``orbax_read.py`` turns the keys into arrays):

  * every manifest, B+tree node and version tree node is a small header
    (magic, uint64 length, format version, compression), a body (a zstd
    frame, ``utils/zstd.py``, or raw) and a CRC32C trailer
    (``utils/crc32c.py``), all checked;
  * the manifest (``manifest.ocdbt``) holds the configuration, the newest
    versions (each a root node reference and statistics) and the version
    tree's node references for older ones;
  * B+tree nodes: a leaf holds keys (prefix-coded against the previous
    key) and values, inline or as a reference into a data file; an
    interior node holds its children's first keys, their common prefixes
    (which the child's keys leave out) and references;
  * a file id is a base path and a relative path, both relative to the
    store's directory: ``ocdbt.process_0/`` and ``d/<name>``.

A checkpoint written by N processes has one root manifest whose newest
version's tree points into every process's files, so ``open`` always
starts there and N processes read like one (``open``). ``dump`` gives the manifest
and nodes as ``tensorstore.ocdbt.dump`` does (the tests hold one against
the other).
"""
from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

from switch_nerf_torch.utils.crc32c import crc32c
from switch_nerf_torch.utils.zstd import ZstdError, decompress

__all__ = ["OcdbtError", "Store", "open", "dump"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_MAGIC = 0x0CDB20DE
_VERSION_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1              # offset/length of an empty tree
_KINDS = {_MANIFEST_MAGIC: "manifest", _BTREE_MAGIC: "btreenode",
          _VERSION_MAGIC: "versionnode"}


class OcdbtError(ValueError):
    """A store, file or node that is not valid OCDBT (the file named)."""


class _Cursor:
    """Forward reads over a decoded body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise OcdbtError(f"{self.where}: truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.where}: a varint past 64 bits")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.where}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node: header and CRC32C checked, zstd
    decoded."""
    if len(raw) < 18:
        raise OcdbtError(f"{where}: truncated ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise OcdbtError(f"{where}: magic {got:#010x}, not a "
                         f"{_KINDS[magic]} ({magic:#010x})")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise OcdbtError(f"{where}: {len(raw)} bytes, its header says "
                         f"{length} (truncated or corrupt)")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{where}: CRC32C mismatch (corrupt)")
    c = _Cursor(raw, where)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise OcdbtError(f"{where}: format version {version}")
    body = raw[c.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"{where}: compression {compression}")
    try:
        return decompress(body)
    except ZstdError as e:
        raise OcdbtError(f"{where}: {e}") from e


def _file_table(c: _Cursor) -> List[Tuple[str, str]]:
    """The data file table: (base path, relative path) of each file,
    each path prefix-coded against the previous one."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{c.where}: a corrupt data file table")
        files.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return files


def _location(kind: str, files, fid: int, offset: int, length: int,
              where: str) -> str:
    if fid >= len(files):
        raise OcdbtError(f"{where}: data file {fid} of {len(files)}")
    base, rel = files[fid]
    return f"{kind}:{base}:{rel}:{offset}:{length}"


def _keys(c: _Cursor, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    """A node's keys, each prefix-coded against the previous one, and (in
    an interior node, whose lengths come before the key bytes) the length
    of each child's common key prefix."""
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        key = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


def _versions(c: _Cursor, n: int, files, where: str) -> List[Dict]:
    """n version entries (a version tree leaf): each its generation, root
    height, root reference, statistics and commit time."""
    gen = c.varints(n)
    height = [c.byte() for _ in range(n)]
    fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
    keys, tree, ind = c.varints(n), c.varints(n), c.varints(n)
    times = [c.u64() for _ in range(n)]
    versions = []
    for i in range(n):
        root = {"statistics": {"num_indirect_value_bytes": ind[i],
                               "num_keys": keys[i],
                               "num_tree_bytes": tree[i]}}
        if off[i] != _MISSING:
            root["location"] = _location("btreenode", files, fid[i], off[i],
                                         ln[i], where)
        versions.append({"commit_time": times[i], "generation_number": gen[i],
                         "root": root, "root_height": height[i]})
    return versions


def _parse_manifest(body: bytes, where: str) -> Dict:
    c = _Cursor(body, where)
    uuid = c.take(16).hex()
    kind = c.varint()
    if kind != 0:
        raise OcdbtError(f"{where}: manifest kind {kind} (numbered "
                         "manifests are not read)")
    config = {"max_inline_value_bytes": c.varint(),
              "max_decoded_node_bytes": c.varint(),
              "version_tree_arity_log2": c.byte(), "uuid": uuid}
    method = c.varint()
    if method == 0:
        config["compression"] = None
    elif method == 1:
        level = int.from_bytes(c.take(4), "little", signed=True)
        config["compression"] = ({"id": "zstd", "level": level} if level
                                 else {"id": "zstd"})
    else:
        raise OcdbtError(f"{where}: compression method {method}")
    files = _file_table(c)
    versions = _versions(c, c.varint(), files, where)
    m = c.varint()
    vgen, vfid, voff, vln = (c.varints(m), c.varints(m), c.varints(m),
                             c.varints(m))
    vnum = c.varints(m)
    vtimes = [c.u64() for _ in range(m)]
    vheight = [c.byte() for _ in range(m)]
    nodes = [{"commit_time": vtimes[i], "generation_number": vgen[i],
              "height": vheight[i],
              "location": _location("versionnode", files, vfid[i], voff[i],
                                    vln[i], where),
              "num_generations": vnum[i]} for i in range(m)]
    if c.pos != len(body):
        raise OcdbtError(f"{where}: {len(body) - c.pos} bytes after the "
                         "manifest")
    return {"config": config, "version_tree_nodes": nodes,
            "versions": versions}


def _parse_btree(body: bytes, where: str) -> Dict:
    c = _Cursor(body, where)
    height = c.byte()
    files = _file_table(c)
    n = c.varint()
    keys, common = _keys(c, n, height > 0)
    entries = []
    if height == 0:
        lengths = c.varints(n)
        kinds = [c.byte() for _ in range(n)]
        ind = [i for i in range(n) if kinds[i] == 1]
        fids, offs = c.varints(len(ind)), c.varints(len(ind))
        refs = dict(zip(ind, zip(fids, offs)))
        for i in range(n):
            if kinds[i] == 1:
                fid, off = refs[i]
                entries.append({"indirect_value": _location(
                    "value", files, fid, off, lengths[i], where),
                    "key": keys[i]})
            elif kinds[i] == 0:
                entries.append({"inline_value": c.take(lengths[i]),
                                "key": keys[i]})
            else:
                raise OcdbtError(f"{where}: value kind {kinds[i]}")
    else:
        fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
        nkeys, tree, ind = c.varints(n), c.varints(n), c.varints(n)
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{where}: a corrupt common prefix")
            entries.append({
                "key": keys[i],
                "location": _location("btreenode", files, fid[i], off[i],
                                      ln[i], where),
                "statistics": {"num_indirect_value_bytes": ind[i],
                               "num_keys": nkeys[i],
                               "num_tree_bytes": tree[i]},
                "subtree_common_prefix": keys[i][:common[i]]})
    if c.pos != len(body):
        raise OcdbtError(f"{where}: {len(body) - c.pos} bytes after the "
                         "node")
    return {"entries": entries, "height": height}


def _parse_version_node(body: bytes, where: str) -> Dict:
    c = _Cursor(body, where)
    arity, height = c.byte(), c.byte()
    files = _file_table(c)
    n = c.varint()
    if height == 0:
        entries = _versions(c, n, files, where)
    else:
        gen = c.varints(n)
        fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
        num = c.varints(n)
        times = [c.u64() for _ in range(n)]
        entries = [{"commit_time": times[i], "generation_number": gen[i],
                    "height": height - 1,
                    "location": _location("versionnode", files, fid[i],
                                          off[i], ln[i], where),
                    "num_generations": num[i]} for i in range(n)]
    if c.pos != len(body):
        raise OcdbtError(f"{where}: {len(body) - c.pos} bytes after the "
                         "node")
    return {"entries": entries, "height": height,
            "version_tree_arity_log2": arity}


class Store(Mapping):
    """The keys of an OCDBT store's newest version, each mapped to its
    value's bytes. Nodes are read when the store opens; an indirect value
    is read from its data file when it is asked for."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.manifest = dump(self.root)
        self._refs: Dict[str, Union[bytes, str]] = {}
        versions = self.manifest["versions"]
        if not versions:
            raise OcdbtError(f"{self.root / 'manifest.ocdbt'}: no version")
        newest = versions[-1]["root"]
        if "location" in newest:
            self._walk(newest["location"], b"")

    def _walk(self, location: str, prefix: bytes) -> None:
        node = self._node(location)
        for e in node["entries"]:
            if "location" in e:
                self._walk(e["location"], prefix + e["subtree_common_prefix"])
            else:
                key = (prefix + e["key"]).decode()
                self._refs[key] = e.get("inline_value",
                                        e.get("indirect_value"))

    def _node(self, location: str) -> Dict:
        return dump(self.root, location)

    def __getitem__(self, key: str) -> bytes:
        ref = self._refs[key]
        if isinstance(ref, bytes):
            return ref
        return _read(self.root, ref)

    def __contains__(self, key) -> bool:
        return key in self._refs

    def __iter__(self) -> Iterator[str]:
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)


def open(root: Union[str, Path]) -> Store:  # noqa: A001 (as gzip.open)
    """The store in directory `root` (its ``manifest.ocdbt``), lazily."""
    return Store(root)


def _split(location: str) -> Tuple[str, Path, int, int, str]:
    kind, base, rel, offset, length = location.rsplit(":", 4)
    return kind, Path(base) / rel, int(offset), int(length), location


def _read(root: Path, location: str) -> bytes:
    """The bytes a location names: kind:base:relative:offset:length."""
    _, rel, offset, length, _ = _split(location)
    path = root / rel
    try:
        with path.open("rb") as f:
            f.seek(offset)
            raw = f.read(length)
    except OSError as e:
        raise OcdbtError(f"{path}: {e}") from e
    if len(raw) != length:
        raise OcdbtError(f"{path}: {len(raw)} bytes at {offset}, "
                         f"{length} referenced (truncated)")
    return raw


def dump(root: Union[str, Path], location: Optional[str] = None):
    """The manifest of the store in `root` (no location), or the node or
    value a location names (``btreenode:``, ``versionnode:``, ``value:``
    ``<base>:<relative>:<offset>:<length>``), as
    ``tensorstore.ocdbt.dump`` gives them: dicts with bytes keys and
    inline values, and a value as bytes."""
    root = Path(root)
    if location is None:
        path = root / "manifest.ocdbt"
        try:
            raw = path.read_bytes()
        except OSError as e:
            raise OcdbtError(f"{path}: {e}") from e
        return _parse_manifest(_unwrap(raw, _MANIFEST_MAGIC, str(path)),
                               str(path))
    kind, rel, offset, length, _ = _split(location)
    raw = _read(root, location)
    if kind == "value":
        return raw
    where = f"{root / rel} at {offset}"
    if kind == "btreenode":
        return _parse_btree(_unwrap(raw, _BTREE_MAGIC, where), where)
    if kind == "versionnode":
        return _parse_version_node(_unwrap(raw, _VERSION_MAGIC, where),
                                   where)
    raise OcdbtError(f"{location}: unknown location kind {kind!r}")
