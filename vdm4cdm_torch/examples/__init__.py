"""User examples: the port's counterparts of the repository's
``examples/`` scripts, run as ``python -m vdm4cdm_torch.examples.<name>``
(``smoke_test``, ``ddnm_inpainting``, ``check_cc``,
``make_generation_jobs``). Each takes ``--device`` (the CUDA card by default,
``cpu`` for the plain versions). ``examples/posterior_analysis.py`` reads
only ``summary.pkl``, whose keys ``cli.calc_ss`` keeps, and runs on the
port's output as it is."""
