"""Vector stores (the interface, the in-memory numpy store, the exact, IVF
and compressed stores on the card: ``gpu``, the C++ CPU store: ``native``,
the sharded fabric: ``fabric``, and the external services' adapters), the
store factory keyed by config, and the ``Retriever`` that joins an
embedder, a store, a reranker and the result cache."""
