"""The port's counterparts of the repo's ``tools/`` that are not bench
scripts: each runs as ``python -m mmlspark_tpu_torch.tools.<name>``.

- ``trace_dump``: the observability plane's reader (traces, SLO alerts,
  TSDB queries, incidents, CPU profiles) over HTTP;
- ``gen_docs``: the API reference from the port's stage registry;
- ``train_zoo_models``: train and publish the zoo's models;
- ``launch_multiprocess``: the two-process drill (psum, fit, pipe,
  checkpoint) over ``torch.distributed``;
- ``chaos_streaming``: the retrain-to-redeploy loop with a worker
  SIGKILLed;
- ``chaos_serving``: the serving fleet's kill, keep-alive, rollout,
  prefix-cache, tenancy, SLO, regression and postmortem drills.
"""
