from repro_torch.models.transformer import Model, build  # noqa: F401
