"""Standalone deployable service components (counterpart of
dynamo_tpu/components/): the metrics service and the KV router service."""
