"""The 2HANDS data pipeline (port of haff_tpu/pipeline): frames and seed
masks -> affordance records -> h5 + json training shards, the device
stages on the card."""
