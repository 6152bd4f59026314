"""The port's own copy of ``pathway_tpu/xpacks/llm/llms.py``: ``BaseChat``,
``EchoChat`` and the API chats (``OpenAIChat``, ``LiteLLMChat``,
``HFPipelineChat``, ``CohereChat``).

Each API chat imports its client (``openai``, ``litellm``, ``transformers``,
``cohere``) only inside the call that needs it, so the module imports none
of them. The async chats run under the engine's UDF executor like any
async UDF. ``EchoChat`` is the deterministic offline model of the tests."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.udfs import UDF


def prompt_chat_single_qa(question: str) -> tuple:
    return ({"role": "system", "content": question},)


_UDF_SETTING_NAMES = (
    "return_type",
    "deterministic",
    "propagate_none",
    "executor",
    "cache_strategy",
    "retry_strategy",
    "timeout",
    "max_batch_size",
)

# the OpenAI chat-completion parameter surface (reference consults
# litellm.get_supported_openai_params; that lib is absent here, so the
# public parameter list is tabled)
_OPENAI_CALL_ARGS = {
    "temperature", "top_p", "max_tokens", "max_completion_tokens", "n",
    "stop", "presence_penalty", "frequency_penalty", "logit_bias",
    "logprobs", "top_logprobs", "seed", "response_format", "stream",
    "stream_options", "tools", "tool_choice", "user", "parallel_tool_calls",
}

# provider prefix -> args NOT accepted (litellm-style routing)
_PROVIDER_UNSUPPORTED = {
    "cohere": {"stream_options", "response_format", "logit_bias"},
}


class BaseChat(UDF):
    def __init__(self, **kwargs):
        settings = {
            k: v for k, v in kwargs.items() if k in _UDF_SETTING_NAMES
        }
        # remaining kwargs are API parameters, exposed as `.kwargs`
        # (reference: BaseChat keeps non-None model kwargs)
        self.kwargs = {
            k: v
            for k, v in kwargs.items()
            if k not in _UDF_SETTING_NAMES and v is not None
        }
        super().__init__(return_type=str, **settings)
        if not hasattr(self, "__wrapped__"):
            # subclasses may define __wrapped__ directly (the reference's
            # BaseChat contract, used by test mocks); _accept is the
            # default body
            self._prepare(self._accept)

    @property
    def executor(self):
        if self._executor is not None:
            return self._executor
        from pathway_tpu_torch.internals.udfs import AutoExecutor

        return AutoExecutor()

    @property
    def cache_strategy(self):
        return self._cache_strategy

    def _accepts_call_arg(self, arg_name: str) -> bool:
        """Whether this model accepts `arg_name` as a per-call parameter
        (reference: BaseChat._accepts_call_arg via litellm)."""
        return False

    def _accept(self, messages, **kwargs) -> str:
        raise NotImplementedError

    def __call__(self, messages: Any, **kwargs) -> expr_mod.ColumnExpression:
        return super().__call__(messages, **kwargs)


def _messages_to_prompt(messages: Any) -> str:
    from pathway_tpu_torch.internals.json import Json

    if isinstance(messages, Json):
        messages = messages.value
    if isinstance(messages, str):
        return messages
    parts = []
    for m in messages:
        if isinstance(m, Json):
            m = m.value
        if isinstance(m, dict):
            content = m.get("content", "")
            if isinstance(content, Json):
                content = content.value
            parts.append(str(content))
        else:
            parts.append(str(m))
    return "\n".join(parts)


class EchoChat(BaseChat):
    """Deterministic offline 'LLM': echoes the tail of the prompt. Useful for
    tests and wiring checks (the reference tests use similar fakes,
    python/pathway/xpacks/llm/tests/mocks.py)."""

    def __init__(self, prefix: str = "", **kwargs):
        self.prefix = prefix
        super().__init__(**kwargs)

    def _accept(self, messages, **kwargs) -> str:
        return self.prefix + _messages_to_prompt(messages)


class OpenAIChat(BaseChat):

    def _accepts_call_arg(self, arg_name: str) -> bool:
        if self.model is None:
            return False
        return arg_name in _OPENAI_CALL_ARGS

    def __init__(self, model: str | None = "gpt-3.5-turbo", **kwargs):
        self.model = model
        self._api_kwargs = {
            k: v
            for k, v in kwargs.items()
            if k in ("api_key", "base_url", "organization")
        }
        super().__init__(**kwargs)

    async def _accept(self, messages, **kwargs) -> str:
        try:
            import openai  # type: ignore[import-not-found]
        except ImportError as exc:
            raise ImportError(
                "OpenAIChat requires the `openai` package"
            ) from exc
        client = openai.AsyncOpenAI(**self._api_kwargs)
        msgs = (
            [{"role": "user", "content": messages}]
            if isinstance(messages, str)
            else list(messages)
        )
        params = {
            k: v
            for k, v in {**self.kwargs, **kwargs}.items()
            if self._accepts_call_arg(k) and v is not None
        }
        ret = await client.chat.completions.create(
            messages=msgs, model=kwargs.get("model", self.model), **params
        )
        return ret.choices[0].message.content


class LiteLLMChat(BaseChat):
    def _accepts_call_arg(self, arg_name: str) -> bool:
        if self.model is None:
            return False
        provider = self.model.split("/", 1)[0] if "/" in self.model else None
        unsupported = _PROVIDER_UNSUPPORTED.get(provider, set())
        return arg_name in _OPENAI_CALL_ARGS and arg_name not in unsupported


    def __init__(self, model: str | None = None, **kwargs):
        self.model = model
        super().__init__()

    async def _accept(self, messages, **kwargs) -> str:
        try:
            import litellm  # type: ignore[import-not-found]
        except ImportError as exc:
            raise ImportError("LiteLLMChat requires `litellm`") from exc
        msgs = (
            [{"role": "user", "content": messages}]
            if isinstance(messages, str)
            else list(messages)
        )
        params = {
            k: v
            for k, v in {**self.kwargs, **kwargs}.items()
            if self._accepts_call_arg(k) and v is not None
        }
        ret = await litellm.acompletion(
            model=kwargs.get("model", self.model), messages=msgs, **params
        )
        return ret["choices"][0]["message"]["content"]


class HFPipelineChat(BaseChat):
    """Local transformers pipeline. Works offline
    when the model is in the local HF cache."""

    def __init__(
        self,
        model: str | None = None,
        call_kwargs: dict = {},
        device: str = "cpu",
        **pipeline_kwargs,
    ):
        self.model = model
        self.call_kwargs = call_kwargs
        self._pipeline = None
        self._pipeline_kwargs = pipeline_kwargs
        super().__init__()

    def _get_pipeline(self):
        if self._pipeline is None:
            from transformers import pipeline

            self._pipeline = pipeline(
                "text-generation", model=self.model, **self._pipeline_kwargs
            )
        return self._pipeline

    def _accept(self, messages, **kwargs) -> str:
        pipe = self._get_pipeline()
        prompt = _messages_to_prompt(messages)
        out = pipe(prompt, **self.call_kwargs)
        text = out[0]["generated_text"]
        if isinstance(text, list):
            text = text[-1].get("content", "")
        return str(text)

    def crop_to_max_length(self, input_string: str, max_prompt_length: int = 500) -> str:
        words = str(input_string).split()
        return " ".join(words[:max_prompt_length])


class CohereChat(BaseChat):

    def __init__(self, model: str | None = "command", **kwargs):
        self.model = model
        super().__init__()

    async def _accept(self, messages, **kwargs) -> str:
        try:
            import cohere  # type: ignore[import-not-found]
        except ImportError as exc:
            raise ImportError("CohereChat requires `cohere`") from exc
        client = cohere.AsyncClient()
        ret = await client.chat(
            message=_messages_to_prompt(messages),
            model=kwargs.get("model", self.model),
        )
        return ret.text
