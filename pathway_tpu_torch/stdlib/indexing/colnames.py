"""The port's own copy of ``pathway_tpu/stdlib/indexing/colnames.py``. Internal column names used by the indexing machinery
(reference: stdlib/indexing/colnames.py)."""

_INDEX_REPLY = "_pw_index_reply"
_MATCHED_ID = "_pw_index_reply_id"
_SCORE = "_pw_index_reply_score"
_QUERY_ID = "_pw_query_id"
_NO_OF_MATCHES = "_pw_index_number_of_matches"
