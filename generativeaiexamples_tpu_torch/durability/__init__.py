"""Durability layer (port of the JAX package's ``durability/``): write-ahead
logged vector stores, atomic snapshots, the ingest-job journal and crash
recovery.

The exact store lives in card memory and the memory store in host memory;
neither survives a restart by itself.  With ``durability.enabled`` every
mutation is appended to a checksummed write-ahead log before it is
applied, periodic atomic snapshots (the store's own ``save()``, the JAX
package's on-disk format) bound replay time, and startup recovery restores
snapshot + WAL tail + journaled bulk-ingest jobs.  The log's frames are
byte for byte the reference's, so either package replays the other's log.
"""

from generativeaiexamples_tpu_torch.durability.journal import IngestJournal
from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore, hydrate_store
from generativeaiexamples_tpu_torch.durability.wal import WalRecord, WriteAheadLog

__all__ = [
    "DurableVectorStore",
    "IngestJournal",
    "WalRecord",
    "WriteAheadLog",
    "hydrate_store",
]
