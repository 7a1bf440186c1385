"""Recursive query-decomposition agent pipeline (port of the JAX package's
``chains/query_decomposition.py``).

Parity with the reference ``query_decomposition_rag`` example
(``examples/query_decomposition_rag/chains.py``): an agent loop that asks
the LLM to either decompose the question into sub-questions for a Search
tool, route arithmetic to a Math tool, or finish; a ledger of (sub-question,
answer) pairs bounds the loop at three hops (``chains.py:150-185``); Search
retrieves then extracts a short answer with a second LLM call
(``chains.py:328-354``); Math parses operands and evaluates safely (the
reference uses ``eval`` — ``chains.py:357-384`` — we use a whitelisted
arithmetic evaluator); the final answer is composed from the ledger
(``chains.py:291-308``).
"""

from __future__ import annotations

import json
import re
from typing import Any, Generator, Optional, Sequence

from generativeaiexamples_tpu_torch.chains.base import ChatTurn
from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot, _llm_params
from generativeaiexamples_tpu_torch.chains.factory import get_chat_llm
from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

MAX_HOPS = 3

_DECOMPOSE_PROMPT = (
    "You decompose questions into tool calls. Tools:\n"
    "- Search: look up facts in the knowledge base\n"
    "- Math: arithmetic on two numbers\n"
    "- Final Answer: no more information is needed\n"
    "Respond with ONLY a JSON object of the form\n"
    '{{"Tool_Request": "Search" | "Math" | "Final Answer", '
    '"Generated Sub Questions": ["..."]}}\n'
    "Question: {question}\n"
    "Information gathered so far:\n{ledger}"
)

_EXTRACT_PROMPT = (
    "Answer the question in one short sentence using only this context.\n"
    "Context:\n{context}\n"
    "Question: {question}"
)

_MATH_PROMPT = (
    "Extract the arithmetic from this question. Respond with ONLY JSON: "
    '{{"operand1": <number>, "operand2": <number>, "operator": "+|-|*|/"}}\n'
    "Question: {question}"
)

_FINAL_PROMPT = (
    "Answer the original question using the gathered information.\n"
    "Original question: {question}\n"
    "Gathered information:\n{ledger}\n"
    "Give a concise final answer."
)


def _complete(llm, prompt: str, **params: Any) -> str:
    return "".join(llm.stream([("user", prompt)], **params))


def _extract_json(text: str) -> Optional[dict]:
    """First {...} block in the text, parsed; None if unparseable."""
    match = re.search(r"\{.*\}", text, re.S)
    if not match:
        return None
    try:
        return json.loads(match.group(0))
    except json.JSONDecodeError:
        return None


def safe_arithmetic(op1: float, op2: float, operator: str) -> float:
    """Whitelisted two-operand arithmetic (replaces the reference's eval)."""
    ops = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
    }
    if operator not in ops:
        raise ValueError(f"unsupported operator {operator!r}")
    return ops[operator](float(op1), float(op2))


class QueryDecompositionChatbot(QAChatbot):
    """Multi-hop agent over the document store."""

    def _search(self, sub_question: str, llm, params: dict) -> str:
        hits = self._retriever.retrieve(sub_question)
        context = self._retriever.build_context(hits)
        if not context.strip():
            return "No information found."
        return _complete(
            llm,
            _EXTRACT_PROMPT.format(context=context, question=sub_question),
            **params,
        ).strip()

    def _math(self, sub_question: str, llm, params: dict) -> str:
        raw = _complete(llm, _MATH_PROMPT.format(question=sub_question), **params)
        spec = _extract_json(raw)
        if spec is None:
            return raw.strip()
        try:
            value = safe_arithmetic(
                spec.get("operand1", 0),
                spec.get("operand2", 0),
                str(spec.get("operator", "+")),
            )
            return str(value)
        except (ValueError, TypeError, ZeroDivisionError) as exc:
            logger.warning("math tool failed: %s", exc)
            return raw.strip()

    def rag_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        llm = get_chat_llm()
        params = _llm_params(llm_settings)
        # Tool-selection calls are greedy; only the final answer streams
        # with the caller's sampling settings.
        tool_params = dict(params)
        tool_params["temperature"] = 0.0

        ledger: list[tuple[str, str]] = []
        for hop in range(MAX_HOPS):
            ledger_text = "\n".join(f"Q: {q}\nA: {a}" for q, a in ledger) or "(none)"
            raw = _complete(
                llm,
                _DECOMPOSE_PROMPT.format(question=query, ledger=ledger_text),
                **tool_params,
            )
            plan = _extract_json(raw)
            if plan is None:
                logger.warning("agent emitted unparseable plan; finishing")
                break
            tool = str(plan.get("Tool_Request", "Final Answer"))
            sub_qs = plan.get("Generated Sub Questions") or []
            logger.info("hop %d: tool=%s sub_questions=%s", hop, tool, sub_qs)
            if tool == "Search":
                for sq in sub_qs[:4]:
                    ledger.append((sq, self._search(str(sq), llm, tool_params)))
            elif tool == "Math":
                for sq in sub_qs[:4]:
                    ledger.append((sq, self._math(str(sq), llm, tool_params)))
            else:  # Final Answer
                break

        ledger_text = "\n".join(f"Q: {q}\nA: {a}" for q, a in ledger) or "(none)"
        # Expose the hops for callers that inspect intermediate agent
        # state (notebook 14; the reference's LangGraph intermediate-steps
        # tutorial observes the same thing).
        self.last_ledger = list(ledger)
        yield from llm.stream(
            [("user", _FINAL_PROMPT.format(question=query, ledger=ledger_text))],
            **params,
        )
