"""Chain-side wiring: the retrieval half of ``chains/factory.py`` (the
chains themselves come with the chain server, ``ROADMAP.md``)."""
