"""Chain server: HTTP + SSE front for the RAG pipelines (port of the JAX
package's ``server/``, on the standard library's ``http.server``)."""

from generativeaiexamples_tpu_torch.server.app import create_app

__all__ = ["create_app"]
