-- The single relation-tuple table (reference migration
-- 20210623162417000000_relationtuple.*.up.sql): network-id scoped rows, one
-- subject kind per row enforced by CHECK, insertion order via rowid seq.
CREATE TABLE keto_relation_tuples (
    seq INTEGER PRIMARY KEY AUTOINCREMENT,
    shard_id TEXT NOT NULL,
    nid TEXT NOT NULL,
    namespace TEXT NOT NULL,
    object TEXT NOT NULL,
    relation TEXT NOT NULL,
    subject_id TEXT,
    subject_set_namespace TEXT,
    subject_set_object TEXT,
    subject_set_relation TEXT,
    commit_time REAL NOT NULL,
    -- exactly one of subject_id / subject_set.* (reference CHECK constraint)
    CHECK ((subject_id IS NULL) <> (subject_set_namespace IS NULL)),
    CHECK ((subject_set_namespace IS NULL) = (subject_set_object IS NULL)
       AND (subject_set_object IS NULL) = (subject_set_relation IS NULL))
);

-- uniqueness of a tuple within a network
CREATE UNIQUE INDEX keto_relation_tuples_uq
    ON keto_relation_tuples (nid, namespace, object, relation,
        ifnull(subject_id, ''), ifnull(subject_set_namespace, ''),
        ifnull(subject_set_object, ''), ifnull(subject_set_relation, ''));

-- partial indexes for each subject kind (reference's
-- partial-index-friendly NULL predicates, relationtuples.go:151-176)
CREATE INDEX keto_relation_tuples_subject_id_idx
    ON keto_relation_tuples (nid, namespace, object, relation, subject_id)
    WHERE subject_id IS NOT NULL;
CREATE INDEX keto_relation_tuples_subject_set_idx
    ON keto_relation_tuples (nid, namespace, object, relation,
        subject_set_namespace, subject_set_object, subject_set_relation)
    WHERE subject_set_namespace IS NOT NULL;
