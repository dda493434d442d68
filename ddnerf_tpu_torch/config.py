"""Configuration.  The port reads the same YAML configs through the JAX
package's config module, which holds no JAX code (frozen dataclasses over a
YAML reader), so it is imported here rather than copied."""

from ddnerf_tpu.config import Config, load_config  # noqa: F401
