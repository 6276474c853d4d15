"""One artifact plane: the kernel-library and state registry.

A content-addressed tree under ``FMRP_REGISTRY_DIR`` (or
``--registry-dir`` / ``run_pipeline(registry_dir=)``) holding

- the port's compiled KERNEL LIBRARIES (:mod:`.executables`), fetched by
  ``cuda_build.build_kernels`` before nvcc runs (the port's stand-in for
  the reference's serialized XLA executables);
- schema-versioned ARTIFACTS (:mod:`.artifacts`): serving states, the
  sweep and backtest frames, audit manifests, Gram banks, and the
  prepared-inputs slots, all guarded by the one manifest layer
  (:mod:`.integrity`);
- the WARM-POOL protocol (:mod:`.warm`): ``warm_from_registry()`` starts
  a quoting-ready serving replica with no build.

The layout and meta keys are the reference package's: a registry either
package writes lists and verifies in the other. Maintenance:
``python -m fm_returnprediction_tpu_torch.registry {ls,verify,gc}``. Off
unless armed; every miss degrades to the path that builds.
"""

from __future__ import annotations

from fm_returnprediction_tpu_torch.registry.artifacts import (
    get_entry_dir,
    get_file,
    list_entries,
    load_serving_state,
    put_files,
    put_serving_state,
)
from fm_returnprediction_tpu_torch.registry.executables import (
    environment_key,
    executable_key,
    fetch_library,
    store_library,
)
from fm_returnprediction_tpu_torch.registry.integrity import (
    CorruptArtifactError,
    array_bundle_digest,
    file_sha256,
)
from fm_returnprediction_tpu_torch.registry.store import (
    REGISTRY_ENV,
    Registry,
    active_registry,
    registry_dir,
    using_registry,
)
from fm_returnprediction_tpu_torch.registry.warm import WarmReport, warm_from_registry

__all__ = [
    "REGISTRY_ENV",
    "Registry",
    "CorruptArtifactError",
    "WarmReport",
    "active_registry",
    "array_bundle_digest",
    "environment_key",
    "executable_key",
    "fetch_library",
    "file_sha256",
    "get_entry_dir",
    "get_file",
    "list_entries",
    "load_serving_state",
    "put_files",
    "put_serving_state",
    "registry_dir",
    "store_library",
    "using_registry",
    "warm_from_registry",
]
