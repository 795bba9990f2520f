"""The port's counterparts of the repo's ``examples/``: each script runs
as ``python -m mmlspark_tpu_torch.examples.<name>`` on the card (or with
``--device cpu`` on the CPU), exposes ``run(...)`` with the JAX script's
sizes as defaults, and prints the JAX script's result line (``--json``
adds one JSON line of its numbers, wall seconds and kernel launches).
"""

#: every example, in the order the JAX package's test lists them
EXAMPLES = ("drug_discovery_quantile", "adult_census_binary",
            "cifar10_resnet_scoring", "transfer_learning", "distributed_sgd",
            "text_classification", "recommender_sar", "interpret_lime",
            "serving_demo", "serving_distributed",
            "flight_delays_regression", "hyperparam_tuning",
            "opencv_image_pipeline", "sequence_tagging",
            "multiclass_image_transfer")
#: the examples whose path fits a GBDT (K9 launches in their process)
GBDT_EXAMPLES = ("drug_discovery_quantile", "adult_census_binary",
                 "flight_delays_regression", "hyperparam_tuning",
                 "text_classification", "interpret_lime",
                 "multiclass_image_transfer", "opencv_image_pipeline",
                 "serving_demo", "serving_distributed")
