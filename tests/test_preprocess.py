"""Test the DiskANN `_disk.index` → packed-bin converter against a fabricated
sector file (layout per BANG_Base/bang_preprocess.py:27-110)."""

import struct

import numpy as np

from bang_jax.constants import DTYPE_FLOAT32
from bang_jax.formats.graph import load_graph_index, load_metadata
from bang_jax.formats.preprocess import SECTOR_LEN, convert_diskann_index


def make_diskann_index(path, vecs, adj_lists, medoid):
    n, d = vecs.shape
    degree = max(len(a) for a in adj_lists)
    max_node_len = d * 4 + 4 + 4 * degree
    nodes_per_sector = SECTOR_LEN // max_node_len
    n_sectors = -(-n // nodes_per_sector)
    file_size = (n_sectors + 1) * SECTOR_LEN

    buf = bytearray(file_size)
    struct.pack_into("<ii", buf, 0, 1, 1)
    struct.pack_into(
        "<QQQQQQQQQ",
        buf,
        8,
        n,
        d,
        medoid,
        max_node_len,
        nodes_per_sector,
        0,
        0,
        0,
        file_size,
    )
    node = 0
    for s in range(n_sectors):
        off = (s + 1) * SECTOR_LEN
        for _ in range(nodes_per_sector):
            if node >= n:
                break
            rec = bytearray(max_node_len)
            rec[: d * 4] = vecs[node].astype("<f4").tobytes()
            nbrs = adj_lists[node]
            struct.pack_into("<I", rec, d * 4, len(nbrs))
            rec[d * 4 + 4 : d * 4 + 4 + 4 * len(nbrs)] = np.asarray(
                nbrs, dtype="<u4"
            ).tobytes()
            buf[off : off + max_node_len] = rec
            off += max_node_len
            node += 1
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return degree


def test_convert_diskann_index(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 37, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    adj_lists = [
        list(rng.choice(n, size=rng.integers(1, 5), replace=False).astype(np.uint32))
        for _ in range(n)
    ]
    degree = 4
    src = tmp_path / "x_disk.index"
    make_diskann_index(src, vecs, adj_lists, medoid=11)

    prefix = str(tmp_path / "out")
    meta = convert_diskann_index(src, prefix, d, DTYPE_FLOAT32, degree)
    assert meta.n == n and meta.medoid == 11 and meta.degree == degree

    loaded_meta = load_metadata(prefix + "_disk_metadata.bin")
    assert loaded_meta.medoid == 11 and loaded_meta.n == n
    out = load_graph_index(prefix)
    np.testing.assert_allclose(out.vectors, vecs)
    for i in range(n):
        got = out.adj[i][: out.degrees[i]]
        assert sorted(set(int(x) for x in adj_lists[i])) == sorted(got)
        assert (out.adj[i][out.degrees[i] :] == i).all()


def test_preprocess_cli_subcommands(tmp_path):
    from bang_jax.formats import preprocess as pp
    from bang_jax.formats.bin_io import load_bin, save_bin

    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 5)).astype(np.float32)
    src = tmp_path / "q.bin"
    dst = tmp_path / "q_mips.bin"
    save_bin(src, q)
    pp.main(["mips-queries", str(src), str(dst)])
    out = load_bin(dst, np.float32)
    assert out.shape == (6, 6)
    np.testing.assert_allclose(np.linalg.norm(out[:, :5], axis=1), 1.0, rtol=1e-5)
