"""The port's admission webhook held against the JAX package.

Every case of tests/test_webhook_process.py runs on both packages: each
side's AdmissionWebhookServer (HTTPS, a self-signed serving cert) behind
its own APIServer, which dispatches every Provisioner write to it with the
registered CA bundle, reached through its own HttpKubeClient. The case's
assertions run on both sides and their records must be equal: the stored
provisioner as a wire dict (uid, resourceVersion and timestamps removed)
and the admission errors' status codes. Every server and client is stopped
by the `stacks` fixture's finalizer.
"""

from __future__ import annotations

import pytest

from tests.test_torch_kube_http import scrub

SIDES = ("ref", "port")


class WKit:
    """One package's webhook server, apiserver, client and builders."""

    def __init__(self, side: str):
        self.side = side
        if side == "ref":
            from karpenter_tpu.api.objects import OP_IN, NodeSelectorRequirement, Taint
            from karpenter_tpu.cloudprovider.fake import FakeCloudProvider
            from karpenter_tpu.kube import certs, codec
            from karpenter_tpu.kube.apiserver import APIServer
            from karpenter_tpu.kube.client import ApiStatusError, HttpKubeClient
            from karpenter_tpu.kube.webhookserver import AdmissionWebhookServer, apply_json_patch, json_patch
            from tests.helpers import make_provisioner
        else:
            from karpenter_tpu_torch.api.objects import OP_IN, NodeSelectorRequirement, Taint
            from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
            from karpenter_tpu_torch.kube import certs, codec
            from karpenter_tpu_torch.kube.apiserver import APIServer
            from karpenter_tpu_torch.kube.client import ApiStatusError, HttpKubeClient
            from karpenter_tpu_torch.kube.webhookserver import AdmissionWebhookServer, apply_json_patch, json_patch
            from karpenter_tpu_torch.testing import make_provisioner
        self.OP_IN, self.NodeSelectorRequirement, self.Taint = OP_IN, NodeSelectorRequirement, Taint
        self.FakeCloudProvider, self.certs, self.codec = FakeCloudProvider, certs, codec
        self.APIServer, self.ApiStatusError, self.HttpKubeClient = APIServer, ApiStatusError, HttpKubeClient
        self.AdmissionWebhookServer, self.apply_json_patch, self.json_patch = AdmissionWebhookServer, apply_json_patch, json_patch
        self.make_provisioner = make_provisioner

    def bad_requirement(self):
        return self.NodeSelectorRequirement("team", self.OP_IN, [])


class Stacks:
    """tests/test_webhook_process.py's `stack`, for either package; every
    server and client is stopped at the end."""

    def __init__(self):
        self._stops = []

    def stack(self, k: WKit, ca_pem=None):
        webhook = k.AdmissionWebhookServer(cloud_provider=k.FakeCloudProvider()).start()
        self._stops.append(webhook.stop)
        api = k.APIServer().start()
        self._stops.append(api.stop)
        api.state.register_webhooks(
            kinds={"Provisioner"},
            mutate_url=webhook.url + "/mutate",
            validate_url=webhook.url + "/validate" if ca_pem is None else None,
            ca_pem=webhook.cert.ca_pem if ca_pem is None else ca_pem,
        )
        client = k.HttpKubeClient(api.url)
        self._stops.append(client.stop)
        return client

    def close(self):
        for stop in reversed(self._stops):
            stop()
        self._stops.clear()


@pytest.fixture
def stacks():
    s = Stacks()
    yield s
    s.close()


def both(scenario, stacks):
    ref, port = (scenario(WKit(side), stacks) for side in SIDES)
    assert port == ref
    return port


class TestJsonPatch:
    def test_diff_and_apply_round_trip(self, stacks):
        def scenario(k, _s):
            before = {"a": 1, "b": {"c": 2, "drop": 3}, "keep": "x"}
            after = {"a": 5, "b": {"c": 2, "new": 7}, "keep": "x", "added": [1, 2]}
            ops = k.json_patch(before, after)
            assert k.apply_json_patch(before, ops) == after
            return ops

        both(scenario, stacks)

    def test_escaped_keys(self, stacks):
        def scenario(k, _s):
            before = {"karpenter.sh/foo": 1}
            after = {"karpenter.sh/foo": 2, "a~b": 3}
            ops = k.json_patch(before, after)
            assert k.apply_json_patch(before, ops) == after
            return ops

        both(scenario, stacks)


class TestWebhookOverTls:
    def test_invalid_provisioner_rejected_with_message(self, stacks):
        def scenario(k, s):
            client = s.stack(k)
            with pytest.raises(k.ApiStatusError) as err:
                client.create(k.make_provisioner(requirements=[k.bad_requirement()]))
            assert err.value.code == 422
            assert "team" in str(err.value)
            return [err.value.code, len(client.list_provisioners())]

        both(scenario, stacks)

    def test_valid_provisioner_admitted_and_defaulted(self, stacks):
        def scenario(k, s):
            client = s.stack(k)
            prov = k.make_provisioner()
            prov.spec.weight = None  # the defaulting webhook must fill this
            prov.spec.taints.append(k.Taint(key="dedicated", value="x", effect=""))
            client.create(prov)
            stored = client.get("Provisioner", prov.name, "")
            assert stored.spec.weight == 0  # defaulting patch applied server-side
            assert stored.spec.taints[0].effect == "NoSchedule"
            return scrub(k.codec.to_wire(stored))

        both(scenario, stacks)

    def test_update_also_runs_admission(self, stacks):
        def scenario(k, s):
            client = s.stack(k)
            prov = k.make_provisioner()
            client.create(prov)
            stored = client.get("Provisioner", prov.name, "")
            stored.spec.requirements = [k.bad_requirement()]
            with pytest.raises(k.ApiStatusError) as err:
                client.update(stored)
            assert err.value.code == 422
            return [err.value.code, scrub(k.codec.to_wire(client.get("Provisioner", prov.name, "")))]

        both(scenario, stacks)

    def test_tls_verification_is_real(self, stacks):
        """A registration carrying the wrong CA fails the handshake and
        surfaces as an admission dispatch error, not a silent pass."""

        def scenario(k, s):
            client = s.stack(k, ca_pem=k.certs.generate_serving_cert().ca_pem)
            with pytest.raises(k.ApiStatusError) as err:
                client.create(k.make_provisioner())
            assert "failed calling webhook" in str(err.value)
            return [err.value.code, len(client.list_provisioners())]

        both(scenario, stacks)
