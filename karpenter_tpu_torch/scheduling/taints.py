"""Taint toleration checking (pkg/scheduling/taints.go:28-40).

Note: like the reference, PreferNoSchedule taints also require a toleration
here — the preference-relaxation pass adds a blanket PreferNoSchedule
toleration when a provisioner carries such a taint (preferences.go:133-147),
which is what restores the kube soft-preference semantics end to end.
"""

from __future__ import annotations

from typing import Optional

from ..api.objects import Pod


class Taints(list):
    """A list of taints with a pod toleration check."""

    def tolerates(self, pod: Pod) -> Optional[str]:
        """Returns an error string if the pod doesn't tolerate every taint."""
        for taint in self:
            if not any(toleration.tolerates(taint) for toleration in pod.spec.tolerations):
                return f"did not tolerate {taint.key}={taint.value}:{taint.effect}"
        return None
