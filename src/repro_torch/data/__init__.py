from repro_torch.data.synthetic import TemplateCorpus, lm_batches  # noqa: F401
