"""Global constants, mirroring the reference's compile-time bounds.

Reference provenance (for parity checking, not copied code):
  - MAX_R=64:            BANG_Base/bang_search.cu:35
  - MAX_L=512:           BANG_Base/bang.h:20
  - BF_ENTRIES=399887:   BANG_Base/bang_search.cu:48 (bloom filter cells/query)
  - extra iterations 50: BANG_Base/bang_search.cu:53 (NAX_EXTRA_ITERATION)
  - 256 PQ centers:      DiskANN PQ convention (BANG_Base/bang_search.cu:263-270)

Here they become static shapes baked into the jit-compiled search program.
"""

# Maximum graph degree (adjacency rows are padded to this).
MAX_R = 64

# Maximum worklist (beam) length.
MAX_L = 512

# Extra search iterations beyond L before the traversal is force-terminated.
DEFAULT_EXTRA_ITERS = 50

# Bloom filter cells per query (prime, same as reference).
BF_ENTRIES = 399887

# Number of PQ centers per chunk (8-bit codes).
PQ_NUM_CENTERS = 256

# dtype codes used in the metadata file (matches bang_preprocess.py argv[4]).
DTYPE_INT8 = 0
DTYPE_UINT8 = 1
DTYPE_FLOAT32 = 2

DTYPE_CODE_TO_NUMPY = {
    DTYPE_INT8: "int8",
    DTYPE_UINT8: "uint8",
    DTYPE_FLOAT32: "float32",
}
NUMPY_TO_DTYPE_CODE = {v: k for k, v in DTYPE_CODE_TO_NUMPY.items()}

# Distance functions (reference: BANG_Base/bang.h:26-30).
ENUM_DIST_L2 = 0
ENUM_DIST_MIPS = 1

# Capability bitmask (reference: BANG_Inmemory/parANN.cu:37-38).
ENABLE_GPU_STATS = 0x1
ENABLE_CACHE_WARMUP = 0x2

# Invalid node-id sentinel used in worklists / visited lists.
INVALID_ID = -1
