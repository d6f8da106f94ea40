"""The model zoo in PyTorch, all ten archs of ``repro_torch.configs``
(``registry.build_model``): the transformer families (dense GQA, MoE, MLA,
the vision-stub VLM), Zamba2 (Mamba2 + a shared attention block) and
xLSTM (``hybrid``, over ``ssm`` and ``xlstm``), and the SeamlessM4T
encoder-decoder (``encdec``)."""
