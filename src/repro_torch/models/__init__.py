"""The model zoo's transformer families in PyTorch: dense GQA, MoE, MLA
and the vision-stub VLM (``registry.build_model``); the ssm, xlstm,
hybrid and encoder-decoder families wait for a later slice of the port
(ROADMAP.md, queue 1, item 7)."""
