"""Framework exceptions.

Copy of ``maggy_tpu/exceptions.py`` (parity: reference
`maggy/core/exceptions.py:22-121`) without the multi-host and run-adoption
errors. `EarlyStopException` is a control-flow exception raised inside the
user's training loop by the Reporter when the driver has flagged the
running trial for early stopping.
"""

from __future__ import annotations


class MaggyTPUError(Exception):
    """Base class for all framework errors."""


class EarlyStopException(MaggyTPUError):
    """Raised in the user training loop when the driver stops the trial.

    Carries the last reported metric so the executor can finalize with it
    (reference `exceptions.py:22-27`).
    """

    def __init__(self, metric):
        super().__init__("Trial stopped early by the driver.")
        self.metric = metric


class ReturnTypeError(MaggyTPUError):
    """User training function returned an unsupported type."""

    def __init__(self, optimization_key, return_val):
        super().__init__(
            "Training function returned {} but must return a number or a dict "
            "containing the optimization key '{}'.".format(
                type(return_val), optimization_key
            )
        )


class MetricTypeError(MaggyTPUError):
    """A reported metric was not numeric."""

    def __init__(self, optimization_key, value):
        super().__init__(
            "The optimization metric '{}' must be numeric, got {}.".format(
                optimization_key, type(value)
            )
        )


class BroadcastMetricTypeError(MaggyTPUError):
    def __init__(self, value):
        super().__init__(
            "reporter.broadcast() requires a numeric metric, got {}.".format(
                type(value)
            )
        )


class BroadcastStepTypeError(MaggyTPUError):
    def __init__(self, step):
        super().__init__(
            "reporter.broadcast() requires an integer step, got {}.".format(type(step))
        )


class BroadcastStepValueError(MaggyTPUError):
    """Steps reported via broadcast must be strictly increasing."""

    def __init__(self, step, last_step):
        super().__init__(
            "reporter.broadcast() steps must be monotonically increasing: got step "
            "{} after step {}.".format(step, last_step)
        )


class AuthenticationError(MaggyTPUError):
    """A control-plane message failed the shared-secret check."""
