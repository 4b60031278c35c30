-- CockroachDB overlay (reference migration
-- 20210623162417000000_relationtuple.cockroach.up.sql): postgres-dialect
-- SQL, but a STORING-free unique constraint on plain columns instead of
-- the expression index (expression indexes landed late in cockroach and
-- NULLs are distinct in unique indexes — the store's exactly-one-subject
-- CHECK makes the plain composite unique equivalent here).
CREATE TABLE keto_relation_tuples (
    seq BIGSERIAL PRIMARY KEY,
    shard_id TEXT NOT NULL,
    nid TEXT NOT NULL,
    namespace TEXT NOT NULL,
    object TEXT NOT NULL,
    relation TEXT NOT NULL,
    subject_id TEXT,
    subject_set_namespace TEXT,
    subject_set_object TEXT,
    subject_set_relation TEXT,
    commit_time DOUBLE PRECISION NOT NULL,
    CHECK ((subject_id IS NULL) != (subject_set_namespace IS NULL)),
    CHECK ((subject_set_namespace IS NULL) = (subject_set_object IS NULL)
       AND (subject_set_object IS NULL) = (subject_set_relation IS NULL))
);

CREATE UNIQUE INDEX keto_relation_tuples_uq
    ON keto_relation_tuples (nid, namespace, object, relation,
        coalesce(subject_id, ''), coalesce(subject_set_namespace, ''),
        coalesce(subject_set_object, ''), coalesce(subject_set_relation, ''));

CREATE INDEX keto_relation_tuples_subject_id_idx
    ON keto_relation_tuples (nid, namespace, object, relation, subject_id)
    WHERE subject_id IS NOT NULL;
CREATE INDEX keto_relation_tuples_subject_set_idx
    ON keto_relation_tuples (nid, namespace, object, relation,
        subject_set_namespace, subject_set_object, subject_set_relation)
    WHERE subject_set_namespace IS NOT NULL;
