"""SSZ: SimpleSerialize encode/decode + hash-tree-root.

The PyTorch port's copy of lighthouse_tpu/ssz: the equivalent of the
reference crates consensus/ssz,
consensus/ssz_derive, consensus/ssz_types, consensus/tree_hash (see
SURVEY.md section 2.2). The `@container` decorator plays the role of the
derive macros; ssz_types' FixedVector/VariableList/Bitfield map to
Vector/List/Bitvector/Bitlist descriptors.
"""

from .hash import (  # noqa: F401
    BYTES_PER_CHUNK,
    ZERO_HASHES,
    hash_concat,
    merkleize,
    mix_in_length,
    pack_bytes,
)
from .cached import (  # noqa: F401
    CachedRoot,
    ChunkTreeCache,
    cached_field_roots,
    cached_root,
)
from .types import (  # noqa: F401
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    SszError,
    SszType,
    Vector,
    boolean,
    container,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
