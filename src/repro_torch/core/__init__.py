"""The paper's byte-offset indexing architecture, on PyTorch and CUDA.

Phase 1 (index construction, Algorithm 2)  → :mod:`repro_torch.core.index`
Phase 2 (targeted extraction, Algorithm 3) → :mod:`repro_torch.core.extract`
Async span read engine (coalesced spans)   → :mod:`repro_torch.core.reader`
Span I/O backends (uring/thread/mmap)      → :mod:`repro_torch.core.iobackend`
Batched verification (hash_mix on device)  → :mod:`repro_torch.core.verify`
Record-content LRU cache                   → :mod:`repro_torch.core.cache`
Baseline (naïve scan, Algorithm 1)         → :mod:`repro_torch.core.baseline`
Identifier layer (InChI/InChIKey roles)    → :mod:`repro_torch.core.identifiers`
Collision discovery (§VI, Eq. 4/5)         → :mod:`repro_torch.core.collisions`
Multi-source intersection (Eq. 1)          → :mod:`repro_torch.core.intersect`
Record substrate (SDF dialect)             → :mod:`repro_torch.core.records`
Synthetic corpus (scale model of PubChem)  → :mod:`repro_torch.core.sdfgen`
Packing layer (ids → uint32 lanes)         → :mod:`repro_torch.core.packing`
Sharded query service (sorted_probe)       → :mod:`repro_torch.core.store`
Similarity search (tanimoto)               → :mod:`repro_torch.core.store`
Bloom-filter prefilter sidecars            → :mod:`repro_torch.core.bloom`
Fingerprint bit-planes (similarity)        → :mod:`repro_torch.core.fingerprint`
"""

from .baseline import BaselineResult, estimate_runtime, measure_scan_throughput, naive_scan
from .collisions import (
    CollisionReport,
    birthday_expectation,
    collisions_from_pairs,
    scan_corpus,
    scan_pairs_sorted,
)
from .cache import CacheStats, RecordCache
from .extract import ExtractionResult, Mismatch, extract, extract_iter, plan_extraction
from .iobackend import RecordView, SpanBackend, resolve_backend, uring_available
from .reader import ReadStats, coalesce_spans, stream_plan
from .verify import VerifyBatcher, compare_ids_batch, recompute_ids_batch
from .identifiers import (
    DEFAULT_KEY_BITS,
    PAPER_KEY_BITS,
    Molecule,
    canonical_id,
    canonical_id_from_structure,
    hashed_key,
    molecule_from_cid,
)
from .index import (
    BinaryIndex,
    ByteOffsetIndex,
    IndexStats,
    build_index,
    file_fingerprints,
    update_index,
)
from .bloom import BloomFilter
from .fingerprint import (
    DEFAULT_FP_BITS,
    fingerprint_batch,
    fold_fingerprint,
    popcount_u32,
)
from .intersect import IntersectionResult, intersect_host, intersect_sorted
from .packing import lanes_for, pack_ids, unpack_ids
from .store import (
    IndexStore,
    QueryStats,
    candidate_runs,
    digest_u64,
    merge_similar_topk,
    save_sharded,
    shard_of,
)
from .records import (
    RECORD_DELIM,
    RecordStore,
    extract_property,
    iter_record_offsets,
    iter_records,
    read_record_at,
    record_properties,
)
from .sdfgen import (
    CorpusManifest,
    CorpusSpec,
    db_id_list,
    db_membership,
    generate_corpus,
    ground_truth_final_dataset,
    ground_truth_intersection,
    load_manifest,
    record_text_for_cid,
)
