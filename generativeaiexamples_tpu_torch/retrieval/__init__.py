"""Vector stores (the interface, the in-memory numpy store, the exact store
on the card: ``gpu``), the store factory keyed by config, and the
``Retriever`` that joins an embedder, a store, a reranker and the result
cache."""
