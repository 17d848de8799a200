"""vidgraph_tpu — a real-time brain-inspired video-memory framework in JAX.

Re-implements the capabilities of the reference VidGraph pipeline
(RaphaelHaddad/Real-Time-Brain-Inspired-Video-Memory) as an idiomatic
JAX / XLA framework running on one GPU (or a mesh of them):

* video chunking + on-device frame preprocessing
* vision tower (ViT) + captioner running batched on the device
* device-resident embedding memory with a fused cosine top-k
* knowledge-graph construction with two-stage LLM triplet extraction
* hybrid online/offline retrieval (vector + fulltext + traversal +
  compression + rerank)
* network-science graph metrics as XLA linear algebra
* benchmark evaluation, export/import, CLI, sweep tooling

(The package name predates the GPU: ``tpu`` in names and in the
``backend`` config values means "in-process JAX".)

External contracts (CLI surface, vlm_output.json schema, export format
v1.0, retrieval/benchmark JSON schemas, YAML config tree) are preserved
from the reference — see SURVEY.md for the file-level parity map.
"""

__version__ = "0.1.0"


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names (JAX reads it itself), else a fixed
    ``.jax_cache`` directory at the root of the checkout.  The path is part
    of the cache key, so it must not move between runs."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache() -> None:
    """First-compile costs (which dominate short CLI invocations) are paid
    once per executable across processes."""
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()
