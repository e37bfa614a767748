from elephas_tpu_torch.api.compile import CompiledModel, compile_model  # noqa: F401
