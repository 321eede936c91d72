"""Token-serving engine (DESIGN.md §9), the port of ``repro.serving``:
continuous batching of generation sequences over preemptible
prefill/decode region kernels.

Lazy exports: ``controller.kernels._register_builtin`` imports
``repro_torch.serving.kernels`` through this package, which must not drag
the engine (and its scheduler imports) into every kernel lookup.
"""
_EXPORTS = {
    "AttentionLM": "repro_torch.serving.attention",
    "AttentionParams": "repro_torch.serving.attention",
    "SamplingParams": "repro_torch.serving.sequence",
    "attention_oracle_stream": "repro_torch.serving.attention",
    "Sequence": "repro_torch.serving.sequence",
    "SequenceCancelled": "repro_torch.serving.sequence",
    "SequenceError": "repro_torch.serving.sequence",
    "SequenceHandle": "repro_torch.serving.sequence",
    "SequenceStatus": "repro_torch.serving.sequence",
    "ServingConfig": "repro_torch.serving.engine",
    "ServingEngine": "repro_torch.serving.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
