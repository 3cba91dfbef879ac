"""Serving stack of the port: ``serving.PagedServingEngine`` over the
``kv_pager`` page allocator.

The reference's inference export (``save_inference_model``,
``StandaloneModel``) and its ``Predictor`` (``Config``,
``create_predictor``) wait for ``inference/export.py`` and
``predictor.py`` (ROADMAP Queue 1 item 4, the rest of the package): the
names are here and raise, naming them."""


def _needs_export(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"inference.{name} needs inference/export.py and predictor.py, "
            "which are not ported (ROADMAP Queue 1 item 4, the rest of the "
            "package)")
    fn.__name__ = name
    return fn


save_inference_model = _needs_export("save_inference_model")
StandaloneModel = _needs_export("StandaloneModel")
Config = _needs_export("Config")
Predictor = _needs_export("Predictor")
create_predictor = _needs_export("create_predictor")
